"""PET modules of the port (the VL-PET-large slice of vlpet_tpu/pet)."""
