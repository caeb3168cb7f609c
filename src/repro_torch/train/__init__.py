"""Training and serving steps of the language-model stack."""
