"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Import the submodules (``repro_torch.kernels.fedavg``); this package
re-exports nothing, so a submodule name always means the submodule.
"""
