"""Models of the port: BART + VL glue and generation."""
