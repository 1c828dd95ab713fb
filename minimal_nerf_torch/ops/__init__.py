"""Rendering math: encoding, sampling, compositing and camera rays."""
