"""Program builders of configurations that the built-in `NodeClassifier`
builder (`port_bench/program.py`) does not cover: `<name>.py` here, with
`build(config, traffic, data, weights, device) -> port_bench.program.Program`,
is chosen by a configuration whose `"model"` is `<name>`. Like
`program.py`, these modules may import the port."""
