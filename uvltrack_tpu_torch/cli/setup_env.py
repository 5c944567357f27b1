"""Generate a local_paths.yaml template (a copy of
uvltrack_tpu/cli/setup_env.py; parity: tracking/create_default_local_file.py
+ the generated local.py modules). It writes the same file as the JAX CLI:
<repo>/local_paths.yaml, which the port's eval/environment.py reads (the
repo is $UVLTRACK_REPO where set, as there, else this checkout).

    python -m uvltrack_tpu_torch.cli.setup_env [--force]
"""

from __future__ import annotations

import argparse
import os

TEMPLATE = """\
# Machine-local dataset/result paths for uvltrack_tpu.
# Env vars UVLTRACK_<NAME>_PATH override these at runtime.
results_path: {repo}/output/test/tracking_results
result_plot_path: {repo}/output/test/result_plots
checkpoints_path: {repo}/checkpoints
pretrained_path: {repo}/pretrain
otb99_path: ''        # .../OTB_sentences  (OTB_videos + OTB_query_train/test)
tnl2k_path: ''        # .../TNL2K_test  (<seq>/imgs + groundtruth.txt + language.txt)
lasot_path: ''        # .../LaSOT  (<class>/<class-N>/...)
lasotext_path: ''     # .../LaSOT_extension_subset
got10k_path: ''       # .../GOT10k (train/ val/ test/ + list.txt)
trackingnet_path: ''  # .../TrackingNet (TRAIN_0..11, TEST)
coco_path: ''         # .../COCO (annotations/, train2017/, train2014/, refcocog/)
nfs_path: ''
uav_path: ''
itb_path: ''
avist_path: ''
tc128_path: ''
otb_path: ''
"""


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)
    repo = os.environ.get("UVLTRACK_REPO", os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    path = os.path.join(repo, "local_paths.yaml")
    if os.path.exists(path) and not args.force:
        print(f"{path} already exists (use --force to overwrite)")
        return
    with open(path, "w") as f:
        f.write(TEMPLATE.format(repo=repo))
    print(f"wrote {path}; fill in your dataset roots")


if __name__ == "__main__":
    main()
