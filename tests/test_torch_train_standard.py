"""The port's non-GAN training step with the standard quantizer against the JAX
``Trainer`` on the CPU: one step's gradients, metrics, the
24-step trajectory and a masked eval step (tolerances in
``torch_train_parity.py``)."""

import pytest
import torch

import torch_train_parity as parity

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return parity.run_pair("standard")


def test_one_step_gradients_match_jax(pair):
    parity.check_gradients(pair)


def test_one_step_metrics_and_buffers_match_jax(pair):
    parity.check_first_step(pair)


def test_trajectory_matches_jax(pair):
    parity.check_trajectory(pair)


def test_eval_step_matches_jax(pair):
    parity.check_eval(pair)
