"""Pinhole / stereo camera models as JAX pytrees.

JAX replacement for ``CPinholeCamera`` (CPinholeCamera.h:11),
``CStereoCamera`` (CStereoCamera.h:9) and their IMU variants
(CPinholeCameraIMU.h:12, CStereoCameraIMU.h:10). The reference precomputes
inverses/transposes and caches them on a heap object; here a camera is an
immutable ``utils.struct`` dataclass of small arrays, so it can be closed over
by ``jit``-compiled functions, ``vmap``-ped, and donated freely. All
projection helpers are batched over leading point dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from svi_mapper_tpu.utils import struct

# Field-of-view safety inset in pixels used for in-view tests
# (ref CPinholeCamera.h:59-61: rectangle inset by 28 px).
FOV_INSET_PX = 28.0


@struct.dataclass
class PinholeCamera:
    """Rectified pinhole camera (ref CPinholeCamera.h:11).

    ``P`` is the 3x4 rectified projection matrix; for a rectified pair the
    right camera has ``P[0, 3] = -fx * baseline``. ``K``/``R_rect``/``dist``
    keep the raw calibration so that un-rectified sources (vi_sensor) can be
    remapped (ref CStereoCamera.h:89-107).
    """

    P: jax.Array          # (3, 4) rectified projection
    K: jax.Array          # (3, 3) raw intrinsics
    dist: jax.Array       # (4,) distortion coefficients (k1 k2 p1 p2)
    R_rect: jax.Array     # (3, 3) rectification rotation
    width: int = struct.field(pytree_node=False, default=0)
    height: int = struct.field(pytree_node=False, default=0)

    # --- derived intrinsics (rectified) -------------------------------------
    @property
    def fx(self) -> jax.Array:
        return self.P[0, 0]

    @property
    def fy(self) -> jax.Array:
        return self.P[1, 1]

    @property
    def cx(self) -> jax.Array:
        return self.P[0, 2]

    @property
    def cy(self) -> jax.Array:
        return self.P[1, 2]

    # --- projections --------------------------------------------------------
    def project(self, p_cam: jax.Array) -> jax.Array:
        """Camera-frame 3D points -> pixel coordinates (u, v).

        Homogeneous-divide projection with the rectified ``P``
        (ref CPinholeCamera.h:118-227 getUV / getHomogenized family).
        Points behind the camera produce garbage UVs — callers mask on
        ``p_cam[..., 2] > 0`` exactly as the reference asserts ``z > 0``.
        """
        ph = jnp.concatenate([p_cam, jnp.ones_like(p_cam[..., :1])], axis=-1)
        uvw = jnp.einsum("ij,...j->...i", self.P, ph, precision=jax.lax.Precision.HIGHEST)
        z = uvw[..., 2]
        safe_z = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        return uvw[..., :2] / safe_z[..., None]

    def back_project(self, uv: jax.Array, depth: jax.Array) -> jax.Array:
        """Pixels + depth -> camera-frame 3D points (rectified model)."""
        x = (uv[..., 0] - self.cx) / self.fx * depth
        y = (uv[..., 1] - self.cy) / self.fy * depth
        return jnp.stack([x, y, depth], axis=-1)

    def normalize(self, uv: jax.Array) -> jax.Array:
        """Pixels -> normalized image coordinates (z = 1 plane)."""
        return jnp.stack(
            [(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy],
            axis=-1,
        )

    def in_fov(self, uv: jax.Array, inset: float = FOV_INSET_PX) -> jax.Array:
        """Inside the inset visibility rectangle (ref CPinholeCamera.h:59-61)."""
        return (
            (uv[..., 0] >= inset)
            & (uv[..., 0] <= self.width - 1 - inset)
            & (uv[..., 1] >= inset)
            & (uv[..., 1] <= self.height - 1 - inset)
        )

    def principal_weight(self, uv: jax.Array) -> jax.Array:
        """Distance-from-principal-point search-window weights (u, v).

        Ref ``getPrincipalWeightU/V = sqrt(|u - c|) / 10``
        (CPinholeCamera.h:220-227) — scales epipolar search ranges by how far
        a feature sits from the image center.
        """
        du = jnp.sqrt(jnp.abs(uv[..., 0] - self.cx)) / 10.0
        dv = jnp.sqrt(jnp.abs(uv[..., 1] - self.cy)) / 10.0
        return jnp.stack([du, dv], axis=-1)


@struct.dataclass
class StereoCamera:
    """Rectified stereo pair (ref CStereoCamera.h:9).

    ``baseline`` is positive; the right projection encodes
    ``P_R[0, 3] = -fx * baseline`` so that for a rectified pair
    ``u_L - u_R = fx * baseline / z > 0`` (disparity invariants
    ref Types.h:48-51).
    """

    left: PinholeCamera
    right: PinholeCamera

    @property
    def baseline(self) -> jax.Array:
        return -self.right.P[0, 3] / self.right.P[0, 0]

    @property
    def width(self) -> int:
        return self.left.width

    @property
    def height(self) -> int:
        return self.left.height

    def depth_from_disparity(self, disparity: jax.Array) -> jax.Array:
        """z = fx * b / d, the rectified stereo depth model
        (ref CTriangulator.cpp:326-356: z = -P_R(0,3) / (uL - uR))."""
        safe_d = jnp.maximum(disparity, 1e-6)
        return -self.right.P[0, 3] / safe_d

    def disparity_from_depth(self, depth: jax.Array) -> jax.Array:
        safe_z = jnp.maximum(depth, 1e-6)
        return -self.right.P[0, 3] / safe_z

    def project_stereo(self, p_cam: jax.Array) -> tuple[jax.Array, jax.Array]:
        """3D camera-frame points -> (uv_left, uv_right)."""
        return self.left.project(p_cam), self.right.project(p_cam)

    def triangulate(self, uv_left: jax.Array, uv_right: jax.Array) -> jax.Array:
        """Rectified linear triangulation from a left/right correspondence.

        Depth from disparity on the u axis, lateral coordinates from the left
        ray (ref CTriangulator.cpp:326-356; matches the reference's
        ``getPointTriangulatedInRIGHT`` math). v coordinates are averaged —
        on perfectly rectified input they are equal (ref Types.h:48).
        """
        disparity = uv_left[..., 0] - uv_right[..., 0]
        z = self.depth_from_disparity(disparity)
        v = 0.5 * (uv_left[..., 1] + uv_right[..., 1])
        x = (uv_left[..., 0] - self.left.cx) / self.left.fx * z
        y = (v - self.left.cy) / self.left.fy * z
        return jnp.stack([x, y, z], axis=-1)


def pinhole_from_projection(
    P: jax.Array, width: int, height: int,
    K: jax.Array | None = None,
    dist: jax.Array | None = None,
    R_rect: jax.Array | None = None,
    dtype=jnp.float32,
) -> PinholeCamera:
    """Build a camera from a 3x4 projection matrix (KITTI-style calibration,
    ref hardware_parameters/kitti_00_camera_left.txt line matProjection)."""
    P = jnp.asarray(P, dtype=dtype).reshape(3, 4)
    if K is None:
        K = P[:, :3]
    if dist is None:
        dist = jnp.zeros(4, dtype=dtype)
    if R_rect is None:
        R_rect = jnp.eye(3, dtype=dtype)
    return PinholeCamera(
        P=P,
        K=jnp.asarray(K, dtype=dtype).reshape(3, 3),
        dist=jnp.asarray(dist, dtype=dtype).reshape(-1)[:4],
        R_rect=jnp.asarray(R_rect, dtype=dtype).reshape(3, 3),
        width=int(width),
        height=int(height),
    )
