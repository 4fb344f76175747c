"""The VL-PET ablation flags of the decoder side on the port's BART
against the JAX package, on CPU, with the helpers and checks of
tests/test_torch_ablation_recipes.py: the VARIANTS recipes of the
cross-attention K/V hooks (the key parallel adapter, the sequential value
adapter with the residual connection, cross and FFN IA3), the decoder's
down-dim adapters with the cross gate, and the decoder's multihead
adapters with the key-value adapter; the port-side recipes of the VPA
with the residual gate, the sequential adapter's gate, the multihead and
pair VPAs, the value hooks that never fire (the self roles' IA3 vectors
and VPAs) and single_adapter.sh's flags with ``--track_z --lambda_z
1e-3``."""

from test_torch_ablation_recipes import ablation_tests

globals().update(ablation_tests([
    "ia3", "key_parallel", "sequential_va", "decoder_adapters",
    "decoder_mh_kv_adapter", "vpa_residual_gate", "sequential_va_gate",
    "mh_vpa", "pair_vpa", "unfired_ia3", "unfired_vpa", "track_z"]))
