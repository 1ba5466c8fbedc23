"""Model config, layers and the dense decoder LM."""
