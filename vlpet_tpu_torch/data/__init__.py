"""Data pipeline of the port: feature readers, per-task datasets,
fixed-shape collation, multitask mixing and tokenization -- copies of
vlpet_tpu/data/ (the video loaders are not ported yet)."""
