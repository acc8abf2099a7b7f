"""The port's examples, each a module with `main(..., device=None)`:
`python -m vamp_mvt_tpu_torch.examples.<name>`.  Ports of `examples/`:
`sphere_cage_example.py`, `random_dance.py`, `attachments.py` and
`flying_sphere.py` need no outside data; `evaluate_mbm.py`,
`prepare_mpnet_dataset.py`, `evaluate_mbm_mpnet.py`,
`prepare_query_dataset.py` and `visualize_mbm.py` read MotionBenchMaker
problems (`bench/mbm.py::load_problems`, or a problem pickle)."""
