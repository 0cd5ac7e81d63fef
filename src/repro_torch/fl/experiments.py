"""Experiment set-ups of the reference's ``repro.fl.experiments`` (CNN task).

Scale: 100 nodes and a few hundred iterations by default (the paper runs
5000-10000). The figure and table experiments come with the baseline systems.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import DagFLConfig
from repro_torch.data.synthetic import MnistLike
from repro_torch.fl.nodes import build_population
from repro_torch.fl.tasks import bench_cnn_task


def default_dagfl_config(num_nodes: int = 100, task: str = "cnn") -> DagFLConfig:
    """Table-I constants; phi/phi0/phi1 differ between the CNN and LSTM rows."""
    if task == "cnn":
        return DagFLConfig(num_nodes=num_nodes, capacity=192, tau_max=20.0,
                           alpha=5, k=2, beta=1)
    return DagFLConfig(
        num_nodes=num_nodes, capacity=192, tau_max=20.0, alpha=5, k=2, beta=5,
        tx_size_bits=3e6 * 8, minibatch_size_bits=9e3 * 8, valset_size_bits=9e3 * 8,
    )


def make_cnn_setup(num_nodes=100, abnormal="normal", num_abnormal=0, seed=0,
                   image_size=16):
    """(bench CNN task, population, global validation set, data generator)."""
    task = bench_cnn_task()
    gen = MnistLike(image_size=image_size, seed=seed)
    nodes = build_population(gen, num_nodes, abnormal, num_abnormal, seed=seed)
    rng = np.random.default_rng(seed + 31)
    gval = gen.balanced(rng, 256)
    return task, nodes, {"x": gval.x, "y": gval.y}, gen
