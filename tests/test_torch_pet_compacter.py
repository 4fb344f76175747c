"""Compacter in the port against the JAX package on BART, on CPU: the
four forms of tests/test_pet_variants.py, with the checks and helpers of
tests/test_torch_pet_recipes.py.

* ``single_compacter`` (scripts/image-text/single_compacter.sh): one
  adapter shared by the tasks, each PHM layer owning a full W and its own
  rule (``--shared_phm_rule False --factorized_phm False``);
* ``compacter_shared_samplers``: per-task adapters whose samplers are
  shared across tasks, the rule shared over tasks;
* ``compacter_shared_W``: the model-root slow weights (factorized
  ``phm_W_down`` / ``phm_W_up``) and the model-root rule injected into
  every PHM layer, which owns only its bias;
* ``compacter_per_task``: per-task factorized W and per-task rules.
"""

import torch

from test_torch_pet_recipes import no_lora_dropout, recipe_tests  # noqa: F401

torch.set_num_threads(2)  # several xdist workers share the host

globals().update(recipe_tests(["single_compacter", "compacter_shared_samplers",
                               "compacter_shared_W", "compacter_per_task"]))
