// PyTorch's rounding rules on the card, shared by the kernels that repeat
// an eager twin bit for bit (shade.cu, nee.cu).  Every file that includes
// this header is built with -fmad=false.
#pragma once

// torch.sum over a last axis of 3: its reduction gives elements 0 and 2 to
// one thread and element 1 to another, then adds the two
__device__ __forceinline__ float sum3(float a0, float a1, float a2) { return (a0 + a2) + a1; }

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
