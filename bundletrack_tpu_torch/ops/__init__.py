"""Depth filtering, cloud + normals, masks, and the port's top-k / scatter helpers."""
