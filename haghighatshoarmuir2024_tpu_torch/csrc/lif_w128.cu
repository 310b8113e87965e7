// The 128-bit mask words' pack pass and K3/K4 instantiations of lif.cu,
// compiled as a translation unit of their own beside it (see lif.cu).
#define HM_LIF_WORD_TU 128
#include "lif.cu"
