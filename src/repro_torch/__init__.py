"""DAG-FL on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

Module names mirror ``repro`` so each port sits where its reference does
(``repro.core.dag`` -> ``repro_torch.core.dag``). The package imports
``torch`` and numpy only; the JAX package is the reference the tests hold
it against, never a dependency.

Entry points default to ``device="cuda"`` and raise without a card; pass
``device="cpu"`` to run on the host, where every kernel takes its plain
PyTorch version.
"""
