"""Command-line tools of the port, the counterparts of the repository's
``tools/``: ``fuzz`` (the differential fuzzer), ``bench`` (the multi-codec
table), ``gen``, ``conv`` and ``swap`` (the reference's 01_gen, 02_conv and
03_swap examples).  Run each as ``python -m qoipp_tpu_torch.tools.<name>``.

Every tool runs its device work on the CUDA device (``--device cuda``)
unless ``--cpu`` (or another ``--device``) is given; asked for ``cuda``
where there is no card, it raises rather than run on the host.
"""


def add_device_args(parser) -> None:
    """The tools' device flags: --device (default cuda) and --cpu."""
    parser.add_argument("--device", default="cuda",
                        help="where the device codecs run (default cuda)")
    parser.add_argument("--cpu", action="store_const", const="cpu",
                        dest="device", help="run the device codecs' plain "
                        "versions on the CPU (--device cpu)")
