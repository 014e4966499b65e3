"""The benchmark's plain float32 reference (`model.py`) and its weight
quantisation (`quant.py`). Imports torch only."""
