"""uvltrack_tpu_torch — the PyTorch/CUDA port of uvltrack_tpu for NVIDIA Hopper.

The package mirrors uvltrack_tpu's tree and names (config/, core/, ops/,
models/, track/) so each module's counterpart is found by path. It imports
torch and never jax or uvltrack_tpu: framework-free modules (config,
tokenizer) are kept as its own copies. The one TPU kernel on the tracking
path (the fused LN+qkv+attention Pallas kernel) is a hand-written CUDA kernel
under csrc/, built with nvcc at first use (ops/build.py).

Entry points (models.build_model, track.Tracker) run on "cuda" unless the
caller passes device="cpu"; on the CPU every kernel wrapper computes its
plain PyTorch version.
"""

__version__ = "0.1.0"
