"""Wan2.1-VACE-1.3B: the DiT with VACE's context blocks (`dit.py`), the
causal Wan-VAE (`vae.py`) and the remover with its flow-matching UniPC
sampler (`model.py`)."""
