"""Shared CLI plumbing: ``--config <yaml>`` plus ``key=value`` overrides."""

from __future__ import annotations

import argparse


def parse_args(description: str, argv=None):
    """--config <yaml> plus optional key=value overrides."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, required=True,
                        help="path of config file")
    parser.add_argument("overrides", nargs="*",
                        help="optional key=value config overrides")
    return parser.parse_args(argv)
