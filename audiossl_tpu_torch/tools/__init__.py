"""The port's tools (counterparts of the JAX package's ``scripts/``, under
the same file names): ``roofline`` (the step's analytic floors at the
H100's peaks), ``profile_step`` (device time of the pretraining step by
kernel, grouped), ``kernel_microbench`` (K2/K3 against K2q/K3q),
``int8_drift`` (the int8 teacher's error budget), ``probe_gain``
(pretraining against a frozen-encoder probe), ``convergence_check`` (loss
and collapse telemetry), ``calculate_min_max`` (a pack's dB range), the
pack tools ``dataset2ards`` and ``check_ards``, ``verify_released`` (the
released-checkpoint check: embeddings against a recorded golden, or a
probe score against an expected one) and ``audioset_strong_prep`` (the
AudioSet-strong TSVs, without pandas).

Each runs as ``python -m audiossl_tpu_torch.tools.<name>`` with the JAX
script's flags plus ``--device`` (the card by default; without one it
raises, and ``--device cpu`` runs the kernels' plain versions), and its
``main(argv)`` returns what it printed as a dict; ``verify_released``
returns its exit code, as JAX's does, and ``audioset_strong_prep``, which
touches no tensor, takes no ``--device``. None imports JAX;
matplotlib is imported only to draw a plot.
"""


def add_device_flag(parser):
    """``--device``: the card unless the caller asks for the CPU."""
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default; raises without "
                             "a card) or cpu (the kernels' plain versions)")
    return parser


def device_of(args):
    """The tool's ``torch.device``: raises for ``cuda`` without a card."""
    from audiossl_tpu_torch.kernels.build import resolve_device

    return resolve_device(args.device)
