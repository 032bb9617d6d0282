"""The benchmark's plain reference: CodeNeRF in float32 PyTorch.

Written from the published model (yuliangguo/code-nerf ``src/model.py``,
``src/utils.py``, ``src/trainer.py``) and kept
apart from the program under test: nothing here imports the port, the
JAX package or JAX. Matrix products run in float32 with TF32 off, or, for
the control that shows the comparison can fail, with their operands
rounded to fp8 (e4m3, one scale per tensor).
"""
