"""The language-model stack: configuration, layers, Mamba-2, the model."""
