"""Two-view geometry: triangulation and epipolar constraints."""
