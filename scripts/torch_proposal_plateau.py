"""The early black plateau of the proposal renderer (and of the flat march
at bound 4, the dense renderer and the multiscale k-planes field), in the
JAX package and in the PyTorch port (CPU).

Both trainers start from the same JAX state (the port's carried over with
``carry.train_state_from_jax``) on a 4-view 64^2 synthetic scene at 1,024
rays per step, and each draws its own rays; the JAX step runs jitted. On the
occupancy-grid renderer (``--config flat``: bound 4, dt_gamma 1/128, the
cameras at radius 2 inside the box) each refreshes its density grid every 16
steps with its own jitter. The script prints the mean loss of every 25 steps
for both, then the mean of one rendered training view (EMA params) against
the ground truth's.

    JAX_PLATFORMS=cpu python scripts/torch_proposal_plateau.py [--config proposal|flat|dense|kplanes] [--steps 150]
"""

import argparse
import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from trinerflet_tpu.data import synthetic as JS  # noqa: E402
from trinerflet_tpu.models import nerf as JN  # noqa: E402
from trinerflet_tpu.models import triplane as JT  # noqa: E402
from trinerflet_tpu.render import renderer as JR  # noqa: E402
from trinerflet_tpu.train import trainer as JTR  # noqa: E402
from trinerflet_tpu_torch.carry import train_state_from_jax  # noqa: E402
from trinerflet_tpu_torch.data import synthetic as PS  # noqa: E402
from trinerflet_tpu_torch.models import nerf as PN  # noqa: E402
from trinerflet_tpu_torch.models import triplane as PT  # noqa: E402
from trinerflet_tpu_torch.render import renderer as PR  # noqa: E402
from trinerflet_tpu_torch.train import trainer as PTR  # noqa: E402

CONFIGS = {  # name -> (TrainConfig, RenderConfig, NeRFConfig) fields
    "proposal": (dict(renderer="proposal"), dict(bound=1.5), {}),
    "flat": (dict(renderer="occgrid"), dict(bound=4.0, dt_gamma=1.0 / 128), {}),
    "dense": (dict(renderer="dense"), dict(bound=1.5, num_steps=64, upsample_steps=32), {}),
    "kplanes": (dict(renderer="occgrid", wavelet_regularization=0.0), dict(bound=1.5),
                dict(encoding="multiscale_k_planes_mul")),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=sorted(CONFIGS), default="proposal")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args()
    t_extra, r_extra, n_extra = CONFIGS[args.config]
    tkw = {**dict(lr=1e-2, iters=10000, num_rays=1024, wavelet_regularization=0.4), **t_extra}
    rkw = dict(grid_size=32, max_steps=128, samples_per_ray_budget=20, **r_extra)
    bound = rkw["bound"]
    tri = dict(channels=16, resolution=64, wavelet_scale=4)
    jtr = JTR.Trainer(JN.NeRFConfig(triplane=JT.TriplaneConfig(**tri), bound=bound, **n_extra),
                      JR.RenderConfig(**rkw), JTR.TrainConfig(**tkw))
    ptr = PTR.Trainer(PN.NeRFConfig(triplane=PT.TriplaneConfig(**tri), bound=bound, **n_extra),
                      PR.RenderConfig(**rkw), PTR.TrainConfig(**tkw), device="cpu")
    js = JS.make_synthetic_scene(num_views=4, H=64, W=64, num_steps=32)
    ps = PS.make_synthetic_scene(num_views=4, H=64, W=64, num_steps=32)
    occgrid = tkw["renderer"] == "occgrid"
    grid = JR.mark_untrained_grid(js.poses, js.intrinsics, jtr.render_cfg) if occgrid else None
    jstate = jtr.init_state(density_grid=grid)
    pstate = train_state_from_jax(jstate, device="cpu")
    jdata, pdata = jtr.scene_to_device(js), ptr.scene_to_device(ps)
    lj, lp = [], []
    for i in range(args.steps):
        if occgrid and i % 16 == 0:
            full = int(pstate.occ.iter_density) < 16
            jstate = jtr._update_grid(jstate, full=full)
            pstate = pstate._replace(occ=ptr.update_grid(pstate.params, pstate.occ,
                                                         generator=pstate.rng, full=full))
        jstate, aux_j = jtr._train_step(jstate, jdata)
        pstate, aux_p = ptr.train_step(pstate, pdata)
        lj.append(float(aux_j["loss"]))
        lp.append(float(aux_p["loss"]))
        if i % 25 == 24:
            print(f"steps {i - 24}-{i}: mean loss JAX {np.mean(lj[-25:]):.5f}, "
                  f"port {np.mean(lp[-25:]):.5f}", flush=True)
    img_j, _ = jtr.render_image(jstate.ema_params, jstate.occ, js.poses[0], js.intrinsics, 64, 64)
    img_p, _ = ptr.render_image(pstate.ema_params, pstate.occ, ps.poses[0], ps.intrinsics, 64, 64)
    gt = js.images[0][..., :3]
    if js.images.shape[-1] == 4:  # composited over the black training background
        gt = gt * js.images[0][..., 3:]
    print(f"view 0 image mean: JAX {np.asarray(img_j).mean():.3e}, port {img_p.mean().item():.3e}, "
          f"ground truth {gt.mean():.3e}; mean loss of a black image {np.mean(gt ** 2) :.5f}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
