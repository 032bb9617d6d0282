"""One module per traffic ``kind``: ``run(ctx)`` sets up, warms up,
measures and checks one cell (see ``portbench/harness/cell.py``)."""
