"""Serving and training steps of the language-model stack."""
