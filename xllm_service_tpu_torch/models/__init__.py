"""Model families of the port (dense Llama-3 for now)."""
