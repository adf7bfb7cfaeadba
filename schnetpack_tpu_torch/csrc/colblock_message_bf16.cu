// The bf16 (kP = 1) instances of the PaiNN column message forward, K1 and K6:
// colblock_message.cu's body in an object of its own, so that nvcc builds
// the three feature precisions in parallel.
#define SPK_PIECES 1
#include "colblock_message.cu"
