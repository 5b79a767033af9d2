"""The off-policy-estimation slice on the card: K3 on NNTrainer's predict,
the CartPole harness's act and Q scoring and DualDICE's zeta forward, each
one launch held to its plain version (1e-5), and the entry points' default
device, the card (their refusal where there is no card is
``test_torch_ope_nets.py::test_entry_points_default_to_the_card``).
Skipped without an NVIDIA card;
on the machine with the card run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_ope.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

K3_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the plain versions
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    from reagent_tpu_torch.ops import fused_mlp

    return fused_mlp.fused_mlp_forward.launches


def test_nn_trainer_predict_is_one_k3_launch(card):
    from reagent_tpu_torch.ope.trainers import NNTrainer, TrainingData
    from reagent_tpu_torch.ops import fused_mlp

    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(4000, 8)), rng.normal(size=4000)
    trainer = NNTrainer(seed=0, device=card)
    trainer.train(TrainingData(x, y), iterations=3)
    before = _launches()
    got = trainer.predict(x)
    assert _launches() == before + 1
    want = fused_mlp.fused_mlp_forward_reference(
        torch.tensor(x, dtype=torch.float32, device=card), trainer.weights(),
        trainer.activations())
    np.testing.assert_allclose(got, want[:, 0].cpu().numpy(), **K3_TOL)


def test_cartpole_harness_launches_k3_each_act_step_and_once_over_the_states(card):
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.ope.test import cartpole
    from reagent_tpu_torch.training import functional

    net = FullyConnectedDQN(4, 2, [128, 64], ["leaky_relu"] * 2).to(card)
    params = functional.params_of(net)
    before = _launches()
    results, gt = cartpole.evaluate_cartpole(net, params, num_episodes=200, horizon=20,
                                             device=card)
    assert _launches() == before + 2 * 20 + 1
    assert np.isfinite(results["ips"].estimated_reward) and gt > 0
    x = torch.randn(20000, 4, device=card)
    torch.testing.assert_close(functional.score(net, params, x), net(x), **K3_TOL)


def test_dualdice_zeta_forward_is_one_k3_launch(card):
    from reagent_tpu_torch.ope.estimators.sequential_estimators import NeuralDualDICE
    from reagent_tpu_torch.ops import fused_mlp
    from reagent_tpu_torch.training import functional

    est = NeuralDualDICE(state_dim=6, num_actions=4, training_samples=2, device=card)
    zeta = est.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(3600, 6, device=card)
    before = _launches()
    got = functional.score(est.net, zeta, x)
    assert _launches() == before + 1
    torch.testing.assert_close(got, fused_mlp.fused_mlp_forward_reference(
        x, functional.k3_weights(zeta, "", 3), ["relu", "relu", "linear"]), **K3_TOL)


def test_entry_points_default_to_the_card(card):
    """Each OPE entry point called with its default device works on the
    card."""
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.ope.estimators.sequential_estimators import NeuralDualDICE
    from reagent_tpu_torch.ope.test import cartpole
    from reagent_tpu_torch.ope.trainers import NNTrainer
    from reagent_tpu_torch.training import functional

    net = FullyConnectedDQN(4, 2, [4], ["relu"])
    results, _, logs = cartpole.evaluate_cartpole(
        net, functional.params_of(net), num_episodes=4, horizon=12, return_logs=True)
    assert np.isfinite(results["ips"].estimated_reward) and logs["states"].shape == (4, 12, 4)
    made = {
        "NNTrainer": NNTrainer(hidden_dim=4).device,
        "NeuralDualDICE": next(NeuralDualDICE(state_dim=6, num_actions=4).net.parameters()).device,
    }
    assert {k: v.type for k, v in made.items()} == {k: "cuda" for k in made}
