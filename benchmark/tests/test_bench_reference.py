"""The reference's frame gradient, computed in blocks of sequences, is the
one computed on every sequence at once."""
import torch

from harness import weights
from mixes import pretrain_step as ps
from reference import atst as ref
from tiny import tiny_cell


def test_blocked_gradient_is_the_whole_one():
    c = tiny_cell("frame_base.pretrain_bf16")["config"]
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(3)
    batch, draws = ps.draw_inputs(gen, c, 4, cpu)
    w = weights.draw(weights.frame_branch_shapes(c, predictor=True), 3, cpu)
    out = []
    for block in (1, 3, 8):
        Ps = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        Pt = {k: v.clone() for k, v in w.items()
              if not k.startswith("head.predictor.")}
        out.append(ref.frame_loss_and_grads(
            Ps, Pt, batch["wav"], batch["valid"], draws, c["num_heads"],
            c["num_layers"], 0.1, block=block))
    (l0, g0, y0), *rest = out
    for loss, g, y in rest:
        assert torch.allclose(y, y0)
        assert torch.allclose(loss, l0, rtol=1e-6, atol=0)
        for k in g0:  # sums over blocks in another order: f32 round-off
            rel = float((g[k] - g0[k]).norm() / g0[k].norm().clamp(min=1e-30))
            assert rel <= 1e-5, (k, rel)
