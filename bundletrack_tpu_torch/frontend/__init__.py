"""Keypoint frontends: the classical Shi-Tomasi frontend and 3D lifting."""
