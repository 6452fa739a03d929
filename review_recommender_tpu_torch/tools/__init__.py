"""Ops tooling: the file archiver (`tools/archiver.py`).

Import submodules directly (`from review_recommender_tpu_torch.tools.archiver
import archive_files`); nothing is re-exported, so `python -m ...archiver`
runs without a double-import warning."""
