"""Argparse flag groups generated from the config dataclasses.

Port of ``gs_tpu/cli/args.py``, the same code over the port's dataclasses.
Behavioral parity with the reference's reflection-based flag system
(``arguments/__init__.py:19-119``): every dataclass field becomes a ``--flag``
with the same name and default; fields listed in the dataclass's
``_shorthands`` map also get the reference's one-letter short option
(``-s/-m/-i/-r/-w``); bools are ``store_true``. ``get_combined_args`` merges a
saved run's ``cfg_args`` with the live CLI exactly like the reference —
except the saved Namespace string is parsed safely (ast) instead of the
reference's ``eval()`` (``arguments/__init__.py:113``).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import sys
from argparse import ArgumentParser, Namespace

from gs_tpu_torch.config import ModelParams


def add_group(parser: ArgumentParser, cls, name: str, sentinel: bool = False):
    """Register one dataclass as an argument group. Returns ``cls``."""
    group = parser.add_argument_group(name)
    shorthands = getattr(cls, "_shorthands", {})
    for f in dataclasses.fields(cls):
        default = None if sentinel else f.default
        names = [f"--{f.name}"]
        if f.name in shorthands:
            names.append(f"-{shorthands[f.name]}")
        if f.type in ("bool", bool):
            group.add_argument(*names, default=default, action="store_true")
        else:
            t = {"int": int, "float": float, "str": str}.get(f.type, type(f.default))
            group.add_argument(*names, default=default, type=t)
    return cls


def extract(cls, args: Namespace):
    """Build a dataclass instance from the parsed Namespace (``extract``,
    arguments/__init__.py:43-49)."""
    kwargs = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(cls)
        if hasattr(args, f.name)
    }
    try:
        return cls(**kwargs)
    except TypeError:  # frozen dataclass with missing fields
        inst = cls()
        for k, v in kwargs.items():
            object.__setattr__(inst, k, v)
        return inst


def parse_saved_namespace(text: str) -> Namespace:
    """Safely parse a ``str(Namespace(...))`` dump (no ``eval``).

    The reference writes ``cfg_args`` as ``str(Namespace)`` (train.py:159-160)
    and reads it back with ``eval()`` (arguments/__init__.py:113). We parse the
    call expression with ``ast`` and accept only literal keyword values.
    """
    tree = ast.parse(text.strip(), mode="eval")
    call = tree.body
    if not (isinstance(call, ast.Call) and getattr(call.func, "id", "") == "Namespace"):
        raise ValueError("cfg_args is not a Namespace(...) dump")
    kwargs = {}
    for kw in call.keywords:
        kwargs[kw.arg] = ast.literal_eval(kw.value)
    return Namespace(**kwargs)


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """Merge saved cfg_args with the live CLI (``arguments/__init__.py:99-119``).

    CLI values that are not None override the saved config.
    """
    cmdline = sys.argv[1:] if argv is None else argv
    args_cmdline = parser.parse_args(cmdline)

    merged = {}
    try:
        cfgfilepath = os.path.join(args_cmdline.model_path, "cfg_args")
        print("Looking for config file in", cfgfilepath)
        with open(cfgfilepath) as f:
            cfgfile_string = f.read()
        print("Config file found: {}".format(cfgfilepath))
        args_cfgfile = parse_saved_namespace(cfgfile_string)
        merged = vars(args_cfgfile).copy()
    except (FileNotFoundError, TypeError):
        print("Config file not found at")
        pass

    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)


def save_cfg_args(model_path: str, model_params: ModelParams) -> None:
    """Persist the run config (``prepare_output_and_logger``, train.py:148-160)."""
    os.makedirs(model_path, exist_ok=True)
    ns = Namespace(**{
        f.name: getattr(model_params, f.name)
        for f in dataclasses.fields(ModelParams)
    })
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(ns))
