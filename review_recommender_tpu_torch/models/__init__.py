"""BERT towers, HF / flax -> torch weight mapping, checkpoint loading,
encoder wrappers, tokenizers."""
