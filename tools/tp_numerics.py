"""How far the tensor-parallel split sits from the unsharded step on the
card, and which of its forms moves that distance.

Run from the repository's root on a machine with a card::

    python3 tools/tp_numerics.py

It prints the card's name and power limit, then:

* the float32-output product a row-split weight's partials take
  (``models/layers.py: _dot32``, on the card ``aten::mm.dtype``) against
  the float64 product of the same bfloat16 operands, at one of
  mamba2-780m's ``out_proj`` partials (4096 x 1536 x 1536), beside the
  product of float32 copies and the bfloat16 product;
* ``chip_smoke.py``'s mesh case (a) — mamba2-780m at full width and
  depth, (8, 2048), two steps, the same seed and batches — as losses: the
  unsharded step (``MESH_ACCUM`` microbatches), the floor
  (``MESH_FLOOR_ACCUM``), and the 4 x 2 split run eagerly as committed
  and with one of its forms swapped back: bfloat16 row partials (each
  partial rounded before the sum), and Mamba-2's B and C computed once a
  unit instead of by every position.  Each loss is printed with its
  distance from the unsharded step's, against ``MESH_LOSS_RTOL``.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def product(card: str) -> None:
    import torch
    from repro_torch.models import layers as L
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(4096, 1536, device="cuda", generator=g).bfloat16()
    b = torch.randn(1536, 1536, device="cuda", generator=g).bfloat16()
    exact = a.double() @ b.double()
    for name, y in (("_dot32", L._dot32(a, b)),
                    ("float32 operands", a.float() @ b.float()),
                    ("bfloat16 output", (a @ b).float())):
        err = float((y.double() - exact).abs().max())
        print(f"  {card}: {name:17s} 4096x1536x1536 max |y - exact| "
              f"{err:.3e} of scale {float(exact.abs().max()):.1f}")


def _bc_once(p, xin, cfg):
    """``ssm._ssm_train_tp`` with B and C computed once a unit (one
    projection and conv, read by every position from one float32 copy)."""
    import torch
    from repro_torch.distributed.spmd import per_position
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SS
    s = cfg.ssm
    n = p["out_proj"]["w"].n
    d_in, N = cfg.d_model * s.expand, s.d_state
    dm, hm = d_in // n, d_in // s.head_dim // n
    w_in, w_conv = p["in_proj"]["w"], p["conv"]
    take = L._Fan(L.apply_norm(p["norm"], xin, cfg.norm))
    bc = SS._conv_silu(L.linear_part({"w": w_in[:, 2 * d_in:2 * d_in + 2 * N]},
                                     take), w_conv[:, d_in:]).float()
    dt0 = 2 * d_in + 2 * N

    def one(m):
        cols = [(m * dm, (m + 1) * dm), (d_in + m * dm, d_in + (m + 1) * dm),
                (dt0 + m * hm, dt0 + (m + 1) * hm)]
        z, x, dtp = torch.tensor_split(L.linear_part(
            {"w": SS._columns(w_in, cols)}, take), [dm, 2 * dm], dim=-1)
        x = SS._conv_silu(x, w_conv[:, m * dm:(m + 1) * dm])
        return SS._ssd_gated(p, cfg, x, z, dtp, bc[..., :N], bc[..., N:],
                             slice(m * hm, (m + 1) * hm))

    return xin + L.row_linear([L._part(p, m)["out_proj"] for m in range(n)],
                              per_position(n, one, xin), xin.dtype)


def losses(card: str) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed.sharding import place
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SS
    from repro_torch.models.layers import tree_map
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    cfg = get_config("mamba2-780m")
    B, S = cs.MESH_TRAIN_BATCH
    source = SyntheticLM(cfg, DataConfig(seq_len=S, global_batch=B,
                                         seed=cs.SEED, mask_boundaries=False))
    batches = [source.batch(i) for i in range(cs.MESH_TRAIN_STEPS)]
    oc = opt.OptConfig()
    p0 = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        cs.SEED))

    def unsharded(accum):
        p = tree_map(torch.clone, p0)
        st = tl.TrainStep(cfg, p, opt.adamw_init(p), oc, accum=accum)
        return [float(st(b)["loss"]) for b in batches]

    def show(name, ls, ref):
        rel = [abs(a - b) / b for a, b in zip(ls, ref)]
        print(f"  {card}: {name:26s} losses {ls}: {rel[0]:.3e}, "
              f"{rel[1]:.3e} from the unsharded step's (band "
              f"{cs.MESH_LOSS_RTOL:.0e})", flush=True)

    lu = unsharded(cs.MESH_ACCUM)
    show(f"unsharded, accum {cs.MESH_ACCUM}", lu, lu)
    show(f"the floor, accum {cs.MESH_FLOOR_ACCUM}",
         unsharded(cs.MESH_FLOOR_ACCUM), lu)
    mesh = make_debug_mesh(*cs.MESH_SHAPE)
    sh = tl.train_state_shardings(p0, mesh, cfg)
    real_dot, real_ssm = L._dot32, SS._ssm_train_tp
    forms = {"4x2 split as committed": {},
             "4x2, bfloat16 row partials": {
                 "dot": lambda x, w: (x @ w).float()},
             "4x2, B and C once a unit": {"ssm": _bc_once}}
    try:
        for name, form in forms.items():
            L._dot32 = form.get("dot", real_dot)
            SS._ssm_train_tp = form.get("ssm", real_ssm)
            ps = place(p0, sh["params"])
            ss = place(opt.adamw_init(p0), sh["opt"])
            step = tl.jit_train_step(cfg, mesh, p0, batches[0], oc,
                                     jit=False)
            show(name, [float(step(ps, ss, b)[2]["loss"]) for b in batches],
                 lu)
            del ps, ss, step
            torch.cuda.empty_cache()
    finally:
        L._dot32, SS._ssm_train_tp = real_dot, real_ssm


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_numerics: no card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    card = cs.card_line()
    print(card)
    t0 = time.perf_counter()
    product(card)
    losses(card)
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
