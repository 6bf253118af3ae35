"""Command-line entry points, after posebyte_tpu/cli/ (reference parity:
the posebyte_demo, benchmark and export_engine binaries, and the evaluation
the reference lacks): demo, evaluate, export and benchmark, each
`python -m posebyte_tpu_torch.cli.<name>`. Every one runs on the CUDA card
unless given `--device cpu`, and refuses, naming the ROADMAP item that
brings it, what the port cannot do yet."""
