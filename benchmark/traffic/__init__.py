"""Kinds of traffic, one module each, named by a workload file's "kind".

A kind provides, each taking the run's `lib/cell.py:Cell`:
  build(cell)                      the scene and the program (seed-free)
  traffic(cell)                    the seed's inputs, and one warm-up call
                                   of each pass or frame they use
  window(cell, seconds, traced)    the measured loop: {"window_s",
                                   "attempted", "failed", "error", ...}
  readings(cell, win, traced)      fields of lib/cell.py:Readings
  sample(cell)                     what the window produced, drawn from
                                   the seed, with its inputs, on the CPU
  release(cell)                    drop the program's state
  reference(cell, samples, dtype)  the plain reference's answers
  numbers(samples, answers, hits_of=None)   the check's numbers
  control_hits(answers)            answers in the form of a run's, to put
                                   the control in the program's place
"""
