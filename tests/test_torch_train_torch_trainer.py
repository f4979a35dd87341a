"""TorchTrainer: gloo process groups + DDP over the worker gang.

The port's mirror of tests/test_torch_trainer.py (reference shape:
python/ray/train/tests/test_torch_trainer.py): the gang forms a real
torch.distributed world (rank-0 TCP rendezvous, gloo on the CPU), DDP
averages gradients across workers, metrics flow via session.report.  This
module imports no JAX: the cluster's workers import it to run its loop.
"""

from _torch_runtime import ray_start  # noqa: F401
from ray_tpu_torch.air import ScalingConfig, session
from ray_tpu_torch.train.torch import TorchTrainer, prepare_model


def _loop(config):
    import torch
    import torch.distributed as dist
    assert dist.is_initialized() and dist.get_world_size() == 2
    assert dist.get_backend() == "gloo"
    rank = dist.get_rank()

    # Gradient averaging check: each rank computes a different loss on
    # the same weights; DDP must produce identical averaged grads.
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1)
    ddp = prepare_model(model, device="cpu")
    x = torch.full((8, 4), float(rank + 1))
    loss = ddp(x).square().mean()
    loss.backward()
    g = model.weight.grad.clone()
    gathered = [torch.zeros_like(g) for _ in range(2)]
    dist.all_gather(gathered, g)
    assert torch.allclose(gathered[0], gathered[1]), "DDP grads differ"

    # Train a real regression to convergence.
    torch.manual_seed(1 + rank)
    model = prepare_model(torch.nn.Linear(4, 1), device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    xs = torch.randn(256, 4)
    ys = xs @ torch.tensor([[1.0], [-2.0], [3.0], [0.5]]) + 0.25
    for epoch in range(30):
        opt.zero_grad()
        loss = (model(xs) - ys).square().mean()
        loss.backward()
        opt.step()
        session.report({"loss": float(loss)})


def test_torch_trainer_ddp_end_to_end(ray_start):  # noqa: F811
    trainer = TorchTrainer(_loop, scaling_config=ScalingConfig(num_workers=2))
    result = trainer.fit()
    assert result.metrics["loss"] < 0.05, result.metrics
    assert len(result.metrics_history) == 30
