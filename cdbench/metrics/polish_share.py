"""The share of the window's problem time spent in the float64 polish
calls, in %: the harness's host-clock spans named ``polish_*`` (each ends
in a synchronize) over the problems' own spans."""


def read(rec):
    ps = rec["problems"]
    pol = sum(v for p in ps for k, v in p.spans.items()
              if k.startswith("polish"))
    tot = sum(p.seconds for p in ps)
    if not ps or tot <= 0 or not any(k.startswith("polish")
                                     for p in ps for k in p.spans):
        return None
    return 100.0 * pol / tot
