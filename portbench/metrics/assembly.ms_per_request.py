"""Milliseconds of the assembly (``fvm_coefficients`` and
``make_flux_spec``) a request, between two device synchronisations that
only the traced run makes."""


def read(run):
    if run.trace is None or run.work.get("kind") != "mgcg":
        return None
    times = [r["assembly_s"] for r in run.requests]
    return sum(times) / len(times) * 1e3
