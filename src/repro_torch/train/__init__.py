"""Serving steps of the language-model stack."""
