"""End-to-end LM training driver on the full fault-tolerance stack
(deterministic pipeline, atomic checkpoints, resume); port of
``examples/train_lm.py``. A reduced same-family config by default; pass
--full for the real config (card scale).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch rwkv6-1.6b --steps 200 [--device cpu]

``--smoke`` makes the run small too (8 steps at batch 2 x 32). Other
arguments go to ``repro_torch.launch.train``; checkpoints go to a fresh
temporary directory unless ``--ckpt-dir`` is given.
"""
import json
import sys
import tempfile

from repro_torch.launch import train


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    small = "--smoke" in argv
    if small:
        argv.remove("--smoke")
    if "--arch" not in argv:
        argv = ["--arch", "qwen3-8b"] + argv
    if "--full" in argv:
        argv.remove("--full")
    else:
        argv.append("--smoke")            # launch.train's reduced config
    defaults = (("--steps", "8"), ("--batch", "2"), ("--seq", "32"),
                ("--log-every", "4")) if small else (("--steps", "200"),)
    defaults += (("--ckpt-dir", tempfile.mkdtemp(prefix="repro_torch_lm_")),
                 ("--ckpt-every", "50"))
    for flag, value in defaults:
        if flag not in argv:
            argv += [flag, value]
    out = train.main(argv)
    losses = out["losses"]
    print(json.dumps({"example": "train_lm", "steps": len(losses),
                      "first_loss": losses[0], "final_loss": losses[-1]}))


if __name__ == "__main__":
    main()
