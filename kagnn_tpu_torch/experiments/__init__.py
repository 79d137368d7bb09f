"""The port's experiment drivers, the counterparts of the repository's
`experiments/node_classification.py`, `graph_classification.py` and
`graph_regression.py`: the same arguments, search spaces and logs, run
with `python -m kagnn_tpu_torch.experiments.<driver>` on the card (or, with
`KAGNN_PLATFORM=cpu`, on the CPU)."""
