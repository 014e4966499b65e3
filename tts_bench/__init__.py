"""tts_bench: the benchmark of the PyTorch and CUDA port,
`qwen3_tts_tpu_torch`, on one NVIDIA H100 (`run.py`; README.md)."""
