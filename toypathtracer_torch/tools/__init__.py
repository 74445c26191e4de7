"""Measurement tools of the port (counterparts of the JAX package's
tools/occupancy.py and tools/vpu_roofline.py), each run as
`python -m toypathtracer_torch.tools.<name>`."""
