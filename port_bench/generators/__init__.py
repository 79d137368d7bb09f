"""Input generators besides the built-in ones (`port_bench/inputs.py`):
`<name>.py` here, with `make(graph, seed, gen, device)` returning the
inputs object that the program's builder and the reference both take, is
chosen by a traffic file whose `graph.generator` is `<name>`. Like the
reference, they import nothing of the port."""
