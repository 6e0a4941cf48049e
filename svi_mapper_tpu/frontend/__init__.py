"""Front-end: temporal tracking, stereo correspondence, epipolar geometry.

Submodules are imported lazily by their users (``frontend.tracking``,
``frontend.stereo``, ``frontend.epipolar``); nothing is re-exported here.
"""
