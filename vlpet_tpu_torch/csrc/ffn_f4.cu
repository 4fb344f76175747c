// F4, the gated FFN's backward (vlpet_gated_ffn_bwd), compiled apart from
// csrc/ffn.cu (which holds its kernels) so that nvcc builds it in parallel
// with F1 / F3 and F2.
#define VLPET_FFN_PART 2
#include "ffn.cu"
