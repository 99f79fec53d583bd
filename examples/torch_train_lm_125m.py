"""End-to-end LM training driver on the PyTorch port: the FULL xlstm-125m
config (125M params) on the synthetic pipeline, as
``examples/train_lm_125m.py`` runs it.

Real training of a real-scale model: on the CUDA card unless ``--device
cpu`` is given (on the CPU expect minutes to hours depending on
``--steps``; ``--steps 20`` is a quick check).

    PYTHONPATH=src python examples/torch_train_lm_125m.py --steps 300 --batch 4
    PYTHONPATH=src python examples/torch_train_lm_125m.py --arch xlstm-125m-smoke \
        --steps 3 --seq 64 --device cpu --ckpt /tmp/xlstm.npz
"""

import argparse

from repro_torch.launch import train as train_driver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="examples/torch_train_lm_125m.py")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--arch", default="xlstm-125m", help="xlstm-125m-smoke on the CPU")
    ap.add_argument("--ckpt", default="experiments/xlstm125m_params.npz")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    argv = [
        "--arch",
        args.arch,
        "--steps",
        str(args.steps),
        "--batch",
        str(args.batch),
        "--seq",
        str(args.seq),
        "--ckpt",
        args.ckpt,
    ]
    if args.device is not None:
        argv += ["--device", args.device]
    return train_driver.main(argv)


if __name__ == "__main__":
    main()
