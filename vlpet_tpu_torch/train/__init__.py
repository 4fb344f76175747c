"""Training of the port: freezing, the HF AdamW optimizer and the step."""
