"""Covers Engine.run_batch's DeprecationWarning; the other shims in mod.py
stay deliberately unexercised.

Named without a test_ prefix so pytest never collects it.
"""
import pytest


def check_run_batch_warns():
    with pytest.warns(DeprecationWarning):
        Engine().run_batch([])                       # noqa: F821
