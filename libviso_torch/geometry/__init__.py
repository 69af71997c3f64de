"""Multi-view geometry: SE(3), epipolar geometry, triangulation."""
