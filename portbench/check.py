"""The comparison that decides `correct`: what the timed path produced,
held against the plain float32 reference (reference/model.py), which works
out every constant again from the raw inputs (frames, boxes, sentences,
weights) and reads the program's outputs only to judge them.

The reference follows each sampled step from the program's own state before
it (the previous box and prompt: a served token's history), as a served
model's reference reads the served tokens; the stages this skips are
checked by themselves: the initial prompts from the first frames, the best
frame's features that a re-mine reads, and each re-mine's prompt.

Numbers (each the widest over the compared rows; a cell's file gives each
its limit, or null for a number reported and not compared):
  prompt_err   |p - p_ref| / |p_ref| of the prompts at initialize and of
               every prompt a sampled step re-mined
  map_err      max |merged - merged_ref| / max merged_ref of the decode's
               map (cls x Hann x contrastive score) of every sampled row
  pick_gap     (max merged_ref - merged_ref[k]) / max merged_ref, k the
               program's pick: how far below the reference's best it lies
  box_err      max |box - box_ref(k)| / the search crop's side, the box in
               image pixels after map-back and clipping
  feat_err     |f - f_ref| / |f_ref| of the features the program kept as
               its best frame's (search, template, visual and text tokens)
               on the rows where this step became the best
  remine_wrong rows whose re-mine decision differs from the reference's by
               more than REMINE_MARGIN of score, or whose prompt changed
               where no re-mine was due
  failed       stream-frames whose step raised or whose box is not finite
"""

from __future__ import annotations

import dataclasses

import torch

REMINE_MARGIN = 0.02  # scores lie in [0, 1]; the decision is max_score > threshold
ORDER = ("prompt_err", "map_err", "pick_gap", "box_err", "feat_err", "remine_wrong", "failed")


@dataclasses.dataclass
class Sample:
    """One sampled step: its bank row, the program's state before and after
    it, the (S, 5) boxes it returned and its (S, 3, cells) maps."""
    row: int
    pre: object
    post: object
    packed: object
    maps: torch.Tensor


def _rel(a, b):
    """Per-row |a - b| / |b| over all but the first axis."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return torch.linalg.vector_norm(a - b, dim=1) / torch.linalg.vector_norm(b, dim=1).clamp_min(1e-30)


class Tally:
    """The numbers of one run: each the widest over its rows (NaN counts as
    infinite), with every row's reading kept for the limits' readings."""

    def __init__(self):
        self.values = {k: 0.0 for k in ORDER}
        self.rows = {k: 0 for k in ORDER}
        self.per_row = {k: [] for k in ORDER}

    def widest(self, key: str, per_row: torch.Tensor) -> None:
        if per_row.numel():
            vals = per_row.double().nan_to_num(float("inf")).cpu().tolist()
            self.values[key] = max(self.values[key], max(vals))
            self.rows[key] += len(vals)
            self.per_row[key] += vals

    def count(self, key: str, n: int, rows: int) -> None:
        self.values[key] += n
        self.rows[key] += rows


def compare(seq, init_prompt, samples, bank, update_interval: int, threshold: float,
            device) -> Tally:
    """seq: the reference's Sequence of the run's streams; init_prompt: the
    program's prompts after initialize; samples: Sample list; bank: the
    (F, S, H, W, 3) frames."""
    t = Tally()
    t.widest("prompt_err", _rel(init_prompt, seq.prompt))
    for s in samples:
        frames = torch.from_numpy(bank[s.row]).to(device)
        pre, post = s.pre, s.post
        active = torch.from_numpy(pre.active.copy()).to(device)
        ref = seq.step(frames, pre.box.float(), pre.prompt.float())
        rows = torch.arange(frames.shape[0], device=device)
        packed = torch.as_tensor(s.packed, device=device)
        m_ref, m = ref["merged"], s.maps[:, 2].float()
        top = m_ref.amax(-1)
        k = m.argmax(-1)
        t.widest("map_err", ((m - m_ref).abs().amax(-1) / top)[active])
        t.widest("pick_gap", ((top - m_ref[rows, k]) / top)[active])
        box_err = (packed[:, :4] - ref["boxes"][rows, k].double()).abs().amax(-1) / ref["crop"]
        t.widest("box_err", box_err[active])
        score = packed[:, 4].float()
        best = (score > pre.max_score) & active
        for name, key in (("search", "best_search"), ("template", "best_template"),
                          ("vis_token", "best_vis_token"), ("txt_token", "best_txt_token")):
            t.widest("feat_err", _rel(getattr(post, key), ref[name])[best])
        # the re-mine: due rows refresh where the new best score beats the
        # threshold (the program zeroes a refreshed row's max_score)
        frame_id = torch.from_numpy(pre.frame_id + pre.active).to(device)
        due = (frame_id % update_interval == 0) & active if update_interval > 0 else active & False
        refreshed = due & (post.max_score == 0)
        score_ref = (ref["cls"] * ref["cont"])[rows, k]
        new_max = torch.where(score_ref > pre.max_score, score_ref, pre.max_score)
        decided = (new_max > threshold) != refreshed
        clear = (new_max - threshold).abs() > REMINE_MARGIN
        unchanged = (post.prompt.float() == pre.prompt.float()).flatten(1).all(1)
        wrong = (due & decided & clear) | (~refreshed & ~unchanged)
        t.count("remine_wrong", int(wrong.sum()), int(active.sum()))
        if bool(refreshed.any()):
            best_feats = {"search": post.best_search, "template": post.best_template,
                          "vis_token": post.best_vis_token, "txt_token": post.best_txt_token,
                          "box_net": post.best_box_net}
            t.widest("prompt_err", _rel(post.prompt, seq.remine(best_feats))[refreshed])
    return t


def stand_in(seq, samples, bank, update_interval: int, threshold: float, device) -> list:
    """The samples as another implementation (`seq`, a reference Sequence,
    e.g. the precision control) produces them from the same states before
    each step: its pick, box and score, its maps, its best features and its
    re-mine, as the program's step computes them (tracker.py's step_body and
    remine_body)."""
    out = []
    for s in samples:
        frames = torch.from_numpy(bank[s.row]).to(device)
        pre = s.pre
        r = seq.step(frames, pre.box.float(), pre.prompt.float())
        rows = torch.arange(frames.shape[0], device=device)
        k = r["merged"].argmax(-1)
        score = (r["cls"] * r["cont"])[rows, k]
        active = torch.from_numpy(pre.active.copy()).to(device)
        best = (score > pre.max_score) & active

        def pick(new, old):
            return torch.where(best.view((-1,) + (1,) * (old.ndim - 1)), new.float(), old)

        post = {"box": r["boxes"][rows, k], "max_score": pick(score, pre.max_score),
                "best_box_net": pick(r["box_net"][rows, k], pre.best_box_net),
                "best_search": pick(r["search"], pre.best_search),
                "best_template": pick(r["template"], pre.best_template),
                "best_vis_token": pick(r["vis_token"], pre.best_vis_token),
                "best_txt_token": pick(r["txt_token"], pre.best_txt_token), "prompt": pre.prompt}
        frame_id = torch.from_numpy(pre.frame_id + pre.active).to(device)
        due = (frame_id % update_interval == 0) & active
        refresh = due & (post["max_score"] > threshold)
        if bool(refresh.any()):
            best_feats = {"search": post["best_search"], "template": post["best_template"],
                          "vis_token": post["best_vis_token"], "txt_token": post["best_txt_token"],
                          "box_net": post["best_box_net"]}
            post["prompt"] = torch.where(refresh[:, None, None], seq.remine(best_feats),
                                         pre.prompt.float())
            post["max_score"] = torch.where(refresh, torch.zeros_like(score), post["max_score"])
        packed = torch.cat([post["box"], score[:, None]], -1).double().cpu().numpy()
        maps = torch.stack([r["cls"], r["cont"], r["merged"]], 1)
        out.append(Sample(s.row, pre, dataclasses.replace(pre, frame_id=pre.frame_id + pre.active,
                                                          **post), packed, maps))
    return out
