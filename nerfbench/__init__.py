"""The benchmark of ``minimal_nerf_torch`` on an NVIDIA H100: one command
runs one cell once (``python3 -m nerfbench.run``; see README.md)."""
