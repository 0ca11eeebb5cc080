"""The systems under test, one module per kind of configuration: each
builds the measured program from a configuration file, makes its weights
and inputs from the seed, serves `call` in the window, and checks what the
window produced against the plain reference (`check`).

A system module defines `System(config, mix, seed, trace, device,
variant)` with `setup()`, `call(params, seed, client)`, `counters()`,
`release()`, `check(records, seed)` and `work(record)`; a configuration
file names its module under "system"."""
