// The mixed (kP = 2) instances of the general PaiNN column message backward, K2
// and K7: colblock_message_gen.cu's backward in an object of its own, so
// that nvcc builds the three feature precisions in parallel.
#define SPK_PIECES 2
#include "colblock_message_gen.cu"
