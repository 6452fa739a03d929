"""BERT towers, flax -> torch weight mapping, encoder wrappers, tokenizers."""
