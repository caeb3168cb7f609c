"""Data pipelines of the language-model stack."""
