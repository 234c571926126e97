"""Model configurations and the Llama family."""
