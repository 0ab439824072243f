"""The benchmark's yardstick: lookup by name, seeded inputs and weights,
the comparisons that decide ``correct``, the work counts and the trace
arithmetic. Nothing here imports ``cl4wsis_tpu_torch`` but the drivers'
set-up, which builds the system under test."""
