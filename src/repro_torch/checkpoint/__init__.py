"""Checkpoints of the language-model stack."""
