"""The language-model stack: config, layers and the dense LM."""
