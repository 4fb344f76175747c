"""The port's command-line entry points, with the reference's flag names
(``python -m vlpet_tpu_torch.cli.multitask``,
``python -m vlpet_tpu_torch.cli.multitask_infer``)."""
