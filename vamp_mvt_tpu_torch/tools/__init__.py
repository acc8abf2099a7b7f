"""Command-line tools of the port: `python -m vamp_mvt_tpu_torch.tools.<name>`.
Port of the repository's `tools/train_mpnet.py`."""
