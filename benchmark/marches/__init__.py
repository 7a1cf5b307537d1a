"""The marches: one module per problem, `marches/<problemType>.py`, found
by the configuration's "problemType" (`spec.march_module`).  A later cell
of another problem brings its own module here; no file of the harness
changes.

A march module gives `benchmark/cell.py`:
  SPANS                     the names of its profiler spans ("slab" marks
                            the traced stretch; "vcycle" and others are
                            read by the per-layer metrics);
  Program(config, device)   the seed-independent set-up, with
                            `dofs_per_slab`, `timings` (named set-up
                            seconds, merged into the run's set-up) and
                            `free()`;
  march(program, traffic, seed, ir_passes=None)
                            one seeded run of it, with
      probe() -> dict       the tolerances, before the warm-up;
      slab() -> (index, solution, ok)
      start, tail(solution) what the next slab starts from;
      vcycles, vcycle_host_s, reset_counters(), spans (a flag), solves;
      free()                drops the device state, keeps the data;
      judge(judged) -> {name: {"value", "limit"}}
                            the reference's judgement of the judged
                            (label, index, solution, start) slabs.
"""
