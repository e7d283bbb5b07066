"""Repeat the MoE training gradient on one CUDA card with another tree's
``models/moe.py`` and with this tree's, and report which gradient leaves
change from one run to the next.

    python3 tools/moe_repeat_ab.py --parent DIR [--out FILE]

DIR is the root of another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into the git-ignored
``build/``.  One process: it builds this tree's kernels, loads DIR's
``src/repro_torch/models/moe.py`` as a module of its own (its imports
resolve to this tree's package) and, in the order parent, this tree,
this tree, parent, makes it the ``moe_apply`` that ``models/model.py``
calls.  Each turn takes qwen2-moe-a2.7b at its published widths, cut to
its first 4 of 24 layers (``chip_smoke.py`` phase 17's cut), random
weights from seed 0, and runs ``train.loss_and_grads`` twice on one
batch of 4 x 1024 tokens of the train CLI's ``MarkovTask`` (seed 0),
every block rematerialized.  It prints one JSON line a turn: whether the
two losses are equal, and each gradient leaf that differs with its count
of differing elements, its max |difference| and its max |gradient|.  All
of it goes to FILE as well (default ``chiprun_out/moe_repeat_ab.json``).
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCH, LAYERS, BATCH, SEQ = "qwen2-moe-a2.7b", 4, 4, 1024


def load_moe(root: Path, name: str):
    """``src/repro_torch/models/moe.py`` of the tree at ``root``, loaded
    as module ``name``."""
    spec = importlib.util.spec_from_file_location(
        name, root / "src" / "repro_torch" / "models" / "moe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def repeat(model, params, batch) -> dict:
    """Two ``loss_and_grads`` on the same params and batch, compared."""
    import torch
    from repro_torch.models.params import leaves
    from repro_torch.train import loss_and_grads

    l1, _, g1 = loss_and_grads(model, params, batch)
    l2, _, g2 = loss_and_grads(model, params, batch)
    differ = []
    for (path, a), (_, b) in zip(leaves(g1), leaves(g2)):
        if not torch.equal(a, b):
            d = (a.float() - b.float()).abs()
            differ.append({"leaf": "/".join(path),
                           "elements": int((d > 0).sum()),
                           "of": a.numel(),
                           "max_abs_diff": float(d.max()),
                           "max_abs_grad": float(a.float().abs().max())})
    return {"loss_equal": bool(torch.equal(l1, l2)), "loss": float(l1),
            "leaves": len(list(leaves(g1))), "leaves_differing": len(differ),
            "differing": differ}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "moe_repeat_ab.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("moe_repeat_ab: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.data import MarkovTask
    from repro_torch.kernels import build
    from repro_torch.models import LM, init_params
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as this_moe

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all()
    variants = {"parent": load_moe(Path(args.parent), "parent_moe"),
                "this tree": this_moe}
    cfg = dataclasses.replace(configs.get_config(ARCH), n_layers=LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    batch = MarkovTask(vocab_size=cfg.vocab_size, seq_len=SEQ,
                       global_batch=BATCH, seed=0).batch(0, dev)
    model = LM(cfg)
    out = {"card": cs.card_line(), "arch": ARCH, "layers": LAYERS,
           "batch": BATCH, "seq": SEQ, "turns": []}
    try:
        for name in ("parent", "this tree", "this tree", "parent"):
            model_mod.moe_apply = variants[name].moe_apply
            turn = {"moe": name, **repeat(model, params, batch)}
            print(json.dumps(turn), flush=True)
            out["turns"].append(turn)
    finally:
        model_mod.moe_apply = this_moe.moe_apply
    print(out["card"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
