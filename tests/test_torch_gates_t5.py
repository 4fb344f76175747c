"""The VL-PET-small, -middleX, -middleY gates and GateLargeX on the port's
T5 against the JAX VLT5, on CPU: the checks of tests/test_torch_gates.py
(forward and loss, 3-step lockstep, beam-5 tokens, trainable set) on a tiny
T5 (d 32, 2+2 layers, vocab 80, 4 boxes of 16-d features) with the T5
recipe flags at r 8. As in the JAX T5, the gates take the pre-norm block
input, middle-Y has no ``_add`` form, no gate reads
``no_encoder_attn_adapter``, and ``use_encoder_adapter_gating_large_x``
builds no gate at all: both packages then train the same tensors."""

import pytest

from test_torch_gates import (VARIANTS, check_beam5, check_forward,
                              check_lockstep, check_trainable_set, setup)


@pytest.fixture(scope="module", params=VARIANTS)
def t5_gate(request):
    return request.param, setup("t5", request.param)


def test_t5_gate_forward_and_loss_match_jax(t5_gate):
    check_forward(t5_gate[1])


def test_t5_gate_train_lockstep_with_jax(t5_gate):
    check_lockstep(t5_gate[1])


def test_t5_gate_beam5_tokens_match_jax(t5_gate):
    check_beam5(t5_gate[1])


def test_t5_gate_trainable_set_matches_jax(t5_gate):
    check_trainable_set(t5_gate[1], t5_gate[0])
