// F2, the FFN's backward (vlpet_ffn_bwd), compiled apart from csrc/ffn.cu
// (which holds its kernels) so that nvcc builds it in parallel with F1 / F3
// and F4.
#define VLPET_FFN_PART 1
#include "ffn.cu"
