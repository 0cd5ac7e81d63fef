"""The paper's LSTM on a card: bitwise repeatable, and within 1e-5 of the CPU.

Imports no JAX, so it runs on a machine with a card and no JAX
(``python -m pytest --noconftest -m cuda``); it skips without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.fl import tasks as t_tasks


@pytest.mark.cuda
def test_card_epochs_are_bitwise_repeatable():
    """Two card epochs of the paper's LSTM give the same floats (the
    embedding's backward sorts, no atomics), within 1e-5 of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tt = t_tasks.LSTMTask()
    cpu = tt.init(0, "cpu")
    card = tt.init(0, "cuda")
    epoch = np.random.default_rng(7).integers(0, 90, (2, 100, 80)).astype(np.int32)
    train = t_tasks.make_epoch_train(tt)
    a, la = train(card, {"tokens": torch.from_numpy(epoch).cuda()})
    b, lb = train(card, {"tokens": torch.from_numpy(epoch).cuda()})
    c, _ = train(cpu, {"tokens": torch.from_numpy(epoch)})
    assert torch.equal(la["loss"], lb["loss"])
    for k in a:
        assert torch.equal(a[k], b[k]), k
        np.testing.assert_allclose(a[k].cpu().numpy(), c[k].numpy(), atol=1e-5, rtol=0)
    # the validation accuracy of the trained model: equal on the card and the CPU
    val = torch.from_numpy(np.random.default_rng(8).integers(0, 90, (64, 80)).astype(np.int32))
    assert float(tt.eval_fn(a, {"tokens": val.cuda()})) == float(tt.eval_fn(c, {"tokens": val}))
