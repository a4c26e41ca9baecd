"""The system under test: ``repro_torch``'s workload server, built from a
configuration file.  Every import of the program is in this module.

The configuration's ``engine`` and ``server`` groups are passed to
``EngineConfig`` and ``ServerOptions`` as they stand; the server's
measured-rates file is pinned off (``measured_rates`` and ``rates_path``
None), so no calibration file found in the checkout can change the
sampling plan being measured.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine import EngineConfig
from repro_torch.core.queries import And, Linear, Query, Range
from repro_torch.data.chunkstore import ChunkStore
from repro_torch.data.formats import AsciiFixedFormat
from repro_torch.kernels import _build
from repro_torch.obs.trace import SpanTracer  # noqa: F401 (the traced run's)
from repro_torch.serve.ola_server import OLAWorkloadServer, ServerOptions


def build_kernels() -> dict:
    """Build (or find built) the program's CUDA kernels."""
    return _build.build_all()


def new_store(config: dict, directory=None) -> ChunkStore:
    codec = AsciiFixedFormat(int(config["table"]["num_cols"]))
    return ChunkStore.create(name=config["name"], codec=codec,
                             directory=directory)


def make_server(config: dict, store: ChunkStore, device,
                tracer=None) -> OLAWorkloadServer:
    server = dict(config["server"])
    rates = (server.pop("measured_rates", None), server.pop("rates_path", None))
    if rates != (None, None):
        raise ValueError("a configuration prices the plan with the modeled "
                         "constants: measured_rates and rates_path are null")
    engine = EngineConfig(**config["engine"])
    options = ServerOptions(**server, measured_rates=None, rates_path=None,
                            tracer=tracer)
    return OLAWorkloadServer(store, engine, options=options, device=device)


def query(spec: dict, confidence: float) -> Query:
    terms = tuple(Range(int(col), -np.inf if lo is None else float(lo),
                        np.inf if hi is None else float(hi))
                  for col, lo, hi in spec["ranges"])
    return Query(agg=spec["agg"], expr=Linear(tuple(spec["coeffs"])),
                 pred=And(terms), epsilon=float(spec["epsilon"]),
                 confidence=float(confidence), name=spec["name"])


def answer_fields(result) -> dict:
    """What an answer says, as plain numbers."""
    return dict(estimate=float(result.estimate), lo=float(result.lo),
                hi=float(result.hi), rounds=int(result.rounds_resident),
                from_synopsis=bool(result.from_synopsis),
                unserved=bool(result.unserved))
