"""The hyperformer, BitFit and full fine-tuning in the port against the
JAX package on BART, on CPU, with the checks and helpers of
tests/test_torch_pet_recipes.py.

* ``hyperformer`` (scripts/image-text/hyperformer.sh): each stack's
  hypernet generates its layers' adapters from the task and layer
  embeddings. Its lockstep starts each port step from the JAX state before
  it (``check_lockstep_per_step``), and its forward check holds the
  per-token loss, not the logits: the JAX hypernet's first layer sums 1024
  fp32 terms in sequence, 3.3e-6 from the fp64 value where the port's sum
  is 5.0e-7 from it; the logits then part by up to 7e-5 against a bound
  of 5.1e-5, and run free, Adam carries it to 2.2e-5 in the third step's
  gradient norm.
* ``bitfit`` (``--unfreeze_bias``): every bias trains, the FFN's through
  F2's db1 / db2 and the LayerNorms' through L2's dbeta on the card;
* ``full_finetuning`` (``--unfreeze_language_model``): the backbone and
  the head train, the FFN on the plain chain.
"""

import torch

from test_torch_pet_recipes import no_lora_dropout, recipe_tests  # noqa: F401

torch.set_num_threads(2)  # several xdist workers share the host

globals().update(recipe_tests(["hyperformer", "bitfit", "full_finetuning"]))
