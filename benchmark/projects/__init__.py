"""Project generators: one module a configuration's `project` names, each
with `build(cfg, seed, d) -> spec`. A spec is a plain dict that describes
the project (rates, files, flowws, vertices, edges, effect plugins and,
for streamed projects, the packets); `lua.write_project(spec, d)` turns it
into `project.toml` and `project.lua`, and the plain reference
(benchmark/reference) renders the same spec."""
