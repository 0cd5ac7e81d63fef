"""Training on a card: attention's backward kernel against its plain version,
and the DAG-FL step on the card against the CPU.

Imports no JAX, so it runs on a machine with a card and no JAX
(``python -m pytest --noconftest -m cuda``); it skips without a card.

The backward kernel (``csrc/flash_attention_bwd.cu``) is held against
``flash_attention_bwd_plain`` run in f32 on the same inputs, within 1e-5 of
each gradient entry's sum of absolute terms (``flash_attention_bwd_scale``;
f32 sums in another order), plus one bf16 unit of the value in bf16 (the
kernel rounds its f32 result once); and it repeats bit for bit. The
reduced model's loss gradient on the card agrees with the CPU's on the same
weights and tokens within 1e-4 of each leaf's largest entry. A reduced
training run on the card repeats bit for bit and agrees with the CPU's on
the same weights and draws within 1e-6 (the parameters, which read 1.8e-7
on an H100; a leaf's change from init is 4.6e-3 or more) and exactly (the
frontier's scores, counters and times).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import cuda_build
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.launch import train as t_train
from repro_torch.models import build_model
from repro_torch.optim.optimizers import tree_leaves, tree_map, value_and_grad
from repro_torch.sharding import fl_step as t_fl

BWD_TOL = 1e-5
GRAD_SHARE, PARAM_ATOL = 1e-4, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU form)")
    return torch.device("cuda")


def bf16_ulp(x):
    mag = x.abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,hd,window", [
    (4, 16, 8, 128, 128, 0),       # the training shape of qwen3-0.6b
    (2, 4, 2, 200, 64, 0), (1, 8, 1, 333, 256, 0), (1, 10, 2, 97, 64, 0),
    (2, 5, 1, 130, 128, 48), (1, 8, 8, 70, 128, 96), (1, 4, 4, 1, 64, 0),
    (1, 8, 1, 300, 256, 40), (1, 6, 3, 31, 128, 0), (1, 6, 3, 33, 128, 5),
])
def test_backward_kernel_on_card(cuda, dtype, B, H, KV, S, hd, window):
    gen = torch.Generator(device=cuda).manual_seed(S + H + hd + window)
    # the model's layout, (B, S, H, hd), passed permuted
    q = (torch.randn((B, S, H, hd), generator=gen, device=cuda) * 0.5).to(dtype).transpose(1, 2)
    k = (torch.randn((B, S, KV, hd), generator=gen, device=cuda) * 0.5).to(dtype).transpose(1, 2)
    v = torch.randn((B, S, KV, hd), generator=gen, device=cuda).to(dtype).transpose(1, 2)
    do = torch.randn((B, S, H, hd), generator=gen, device=cuda).to(dtype).transpose(1, 2)
    before = cuda_build.LAUNCHES["flash_attention_bwd"]
    got = t_fa.flash_attention_bwd(q, k, v, do, window)
    again = t_fa.flash_attention_bwd(q, k, v, do, window)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["flash_attention_bwd"] == before + 2
    args32 = [t.float() for t in (q, k, v, do)]
    want = t_fa.flash_attention_bwd_plain(*args32, window)
    scale = t_fa.flash_attention_bwd_scale(*args32, window)
    for g, a, w, m in zip(got, again, want, scale):
        assert torch.equal(g, a) and g.dtype == dtype and g.shape == w.shape
        tol = BWD_TOL * m + (bf16_ulp(w) if dtype == torch.bfloat16 else 0)
        assert bool(((g.float() - w).abs() <= tol).all()), float(((g.float() - w).abs() / tol).max())


@pytest.mark.cuda
def test_backward_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 4, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        t_fa.flash_attention_bwd(q, q[:, :2], q[:, :2], q)
    q = torch.zeros((1, 4, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="dout"):
        t_fa.flash_attention_bwd(q, q[:, :2], q[:, :2], q.bfloat16())


@pytest.mark.cuda
def test_training_gradient_goes_through_both_kernels(cuda):
    cfg = get_arch("qwen3-0.6b").reduced()
    model = build_model(cfg)
    params = tree_map(lambda p: p.requires_grad_(True), model.init(0, device="cuda"))
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    cuda_build.LAUNCHES.clear()
    total, _ = model.loss(params, {"tokens": toks, "labels": toks})
    total.backward()
    torch.cuda.synchronize()
    # forward, the checkpointed recompute, and one backward a layer
    assert cuda_build.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
    assert cuda_build.LAUNCHES["flash_attention_bwd"] == cfg.num_layers
    assert all(bool(torch.isfinite(p.grad).all()) for p in tree_leaves(params))


@pytest.mark.cuda
def test_card_gradient_agrees_with_the_cpu(cuda):
    cfg = get_arch("qwen3-0.6b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 64)))
    grads = {}
    for device in ("cuda", "cpu"):
        batch = {"tokens": toks.to(device), "labels": toks.to(device)}
        _, grads[device] = value_and_grad(model.loss, tree_map(lambda p: p.to(device), params),
                                          batch, has_aux=True)
    for g, c in zip(tree_leaves(grads["cuda"]), tree_leaves(grads["cpu"])):
        assert float((g.cpu() - c).abs().max()) <= GRAD_SHARE * float(c.abs().max())


@pytest.mark.cuda
def test_card_training_repeats_and_agrees_with_the_cpu(cuda):
    cfg = get_arch("qwen3-0.6b").reduced()
    model = build_model(cfg)
    cpu_params = t_train.init_stacked(model, 4, 0, torch.device("cpu"))
    draws = [torch.from_numpy(np.random.default_rng(s).random((4, 4), dtype=np.float32) * 0.999
                              + 1e-9) for s in range(2)]
    runs = {}
    for label, device in (("card", "cuda"), ("again", "cuda"), ("cpu", "cpu")):
        cuda_build.LAUNCHES.clear()
        params = tree_map(lambda p: p.to(device), cpu_params)
        runs[label] = t_train.run(cfg, steps=2, seq_len=64, lr=0.3, device=device,
                                  params=params, draws=lambda step: draws[step])
        if device == "cuda":
            assert cuda_build.LAUNCHES["fedavg_gather"] == 2 * 4 * len(tree_leaves(cpu_params))
            assert cuda_build.LAUNCHES["flash_attention_bwd"] == 2 * 4 * cfg.num_layers
    card, again, cpu = runs["card"], runs["again"], runs["cpu"]
    for a, b, c in zip(tree_leaves(card.stacked), tree_leaves(again.stacked),
                       tree_leaves(cpu.stacked)):
        assert torch.equal(a, b)
        assert float((a.cpu() - c).abs().max()) <= PARAM_ATOL
    for name in t_fl.Frontier._fields:
        assert torch.equal(getattr(card.frontier, name), getattr(again.frontier, name))
        assert torch.equal(getattr(card.frontier, name).cpu(), getattr(cpu.frontier, name)), name


@pytest.mark.cuda
def test_card_aggregation_is_the_kernel(cuda):
    sel = t_fl.Selection(torch.eye(3, device=cuda),
                         torch.arange(3, dtype=torch.int32, device=cuda)[:, None],
                         torch.ones((3, 1), device=cuda))
    stacked = {"w": torch.randn((3, 5, 7), device=cuda)}
    before = cuda_build.LAUNCHES["fedavg_gather"]
    out = t_fl.aggregate(sel, stacked)
    assert cuda_build.LAUNCHES["fedavg_gather"] == before + 3
    assert torch.equal(out["w"], stacked["w"])
    with pytest.raises(ValueError, match="plain version"):
        t_fl.aggregate(sel, stacked, "einsum")
