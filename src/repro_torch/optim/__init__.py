"""Optimizers of the language-model stack."""
