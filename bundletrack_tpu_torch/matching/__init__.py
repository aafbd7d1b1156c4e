"""Pairwise mutual-NN matching with geometric gates, and the landmark table."""
