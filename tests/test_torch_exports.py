"""The port's subpackages export every public name of their JAX twins
(fault F7): for each of ``run``, ``spectrum``, ``deposit``, ``io``,
``utils``, ``parallel`` and ``fft``, every name in the JAX ``__all__``
is in the port's ``__all__`` and resolves.  Names waiting for a ROADMAP
item would be listed here; none is left."""
import importlib

import pytest

# name -> the ROADMAP item that ports it
WAITING = {}


@pytest.mark.parametrize("sub", ["run", "spectrum", "deposit", "io",
                                 "utils", "parallel", "fft"])
def test_subpackage_exports_match_jax(sub):
    ref = importlib.import_module(f"vpower_tpu.{sub}")
    got = importlib.import_module(f"vpower_tpu_torch.{sub}")
    waiting = WAITING.get(sub, {})
    missing = [n for n in ref.__all__
               if n not in waiting and (n not in got.__all__
                                        or not hasattr(got, n))]
    assert missing == []
    assert [n for n in got.__all__ if not hasattr(got, n)] == []
    # a waiting name is really missing, so the list stays true
    assert [n for n in waiting if hasattr(got, n)] == []
