"""Faults planted under the timed path, for the test that sees `correct`
come out false and for the readings of the numbers the precision control
cannot separate: each is `fault(streams)`, applied by cell.run after set-up
(graphs captured), so it breaks the CUDA-graph step and its CPU stand-in
alike.

  unchanged      a step that returns its state unchanged: no replay, the old
                 boxes handed back, the state kept
  half_left_out  half of the batch left out: rows S/2.. of the step's boxes
                 and new state replaced by the mean of the other rows
  altered        an answer altered where it is produced: the step graph's
                 boxes moved by a quarter of their size, right and down

(The exchange between chips, the fourth fault, does not exist in one-chip
cells.)"""

from __future__ import annotations

import torch


def unchanged(drv) -> None:
    t = drv.t

    def step(load, hw, always_remine):
        st = t.state
        return torch.cat([st.box, st.max_score[:, None]], -1)

    t._graph_step = step


def half_left_out(drv) -> None:
    from uvltrack_tpu_torch.track.tracker import BatchState

    t, inner = drv.t, drv.t._graph_step

    def step(load, hw, always_remine):
        packed = inner(load, hw, always_remine).clone()
        h = t.S // 2
        st = t.state
        fields = {k: getattr(st, k) for k in BatchState.__dataclass_fields__}
        for k in ("box", "max_score", "best_box_net", "best_search", "best_template",
                  "best_vis_token", "best_txt_token", "prompt"):
            v = fields[k].clone()
            v[h:] = v[:h].float().mean(0, keepdim=True).to(v.dtype)
            fields[k] = v
        t.state = BatchState(**fields)
        packed[h:] = packed[:h].mean(0, keepdim=True)
        return packed

    t._graph_step = step


def altered(drv) -> None:
    jt = drv.t.jt
    inner = jt.replay_step

    def replay(gs):
        out = inner(gs)
        shift = torch.cat([out["box"][:, 2:] / 4, torch.zeros_like(out["box"][:, 2:])], -1)
        out["box"] += shift
        out["packed"][:, :4] += shift
        return out

    jt.replay_step = replay


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out, "altered": altered}
