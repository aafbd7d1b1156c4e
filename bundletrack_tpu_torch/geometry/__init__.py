"""SE(3)/SO(3), Huber, Kabsch and 3-point Procrustes, pinhole camera."""
