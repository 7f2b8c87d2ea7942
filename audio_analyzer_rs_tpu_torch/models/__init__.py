"""models of the PyTorch/CUDA port (mirrors audio_analyzer_rs_tpu/models)."""
