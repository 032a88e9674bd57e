"""What the port's CLIs share: the ``--device`` option and the tools' shards."""

from __future__ import annotations


def add_device(parser):
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs on the CPU)")


def shards(data: dict, split: int):
    """``data``'s items in ``split`` consecutive shards (the tools' 16-way split)."""
    items = list(data.items())
    return [dict(items[len(items) * i // split : len(items) * (i + 1) // split])
            for i in range(split)]
