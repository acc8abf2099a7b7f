"""Examples that need no outside data, each a module with `main(...,
device=None)`: `python -m vamp_mvt_tpu_torch.examples.<name>`.  Ports of
`examples/sphere_cage_example.py`, `random_dance.py`, `attachments.py` and
`flying_sphere.py`."""
