"""The port held to the reference's graph suite (tests/test_graph.py):
cycles, connects, path checks, topological order, the time cursor and
clamps, and a deep chain, through termdaw_tpu_torch's graph/graph.py with
the same assertions. Host-only (no device). Imports nothing of JAX or
termdaw_tpu."""


from termdaw_tpu_torch.graph import Graph, VertexDecl
from termdaw_tpu_torch.graph import graph as G


def g3():
    g = Graph(64, 8000)
    g.add(VertexDecl("a", G.SUM))
    g.add(VertexDecl("b", G.SUM))
    g.add(VertexDecl("c", G.SUM))
    return g


class TestGraph:
    def test_cycle_rejected(self):
        """Mirror of tests/test_graph.py::TestGraph::test_cycle_rejected."""
        g = g3()
        assert g.connect("a", "b")
        assert g.connect("b", "c")
        assert not g.connect("c", "a")  # would close a loop
        assert not g.connect("a", "a")  # self loop

    def test_connect_unknown_warns_returns_false(self, capsys):
        """Mirror of tests/test_graph.py::TestGraph::
        test_connect_unknown_warns_returns_false."""
        g = g3()
        assert not g.connect("nope", "a")
        assert "can't be connected" in capsys.readouterr().out
        assert not g.connect("a", "nope")
        assert "can't be connected to" in capsys.readouterr().out

    def test_connect_to_inputless_vertex_rejected(self):
        """Mirror of tests/test_graph.py::TestGraph::
        test_connect_to_inputless_vertex_rejected."""
        g = Graph(64, 8000)
        g.add(VertexDecl("gen", G.SAMPLELOOP, params={"sample_index": 0}))
        g.add(VertexDecl("mix", G.SUM))
        assert not g.connect("mix", "gen")  # generators take no inputs
        assert g.connect("gen", "mix")

    def test_check_graph_paths(self, capsys):
        """Mirror of tests/test_graph.py::TestGraph::test_check_graph_paths."""
        g = g3()
        # no output set
        assert not g.check_graph()
        assert "output vertex not found" in capsys.readouterr().out
        # output with no inputs
        g.set_output("c")
        assert not g.check_graph()
        assert "receives no inputs" in capsys.readouterr().out
        # valid, with one unreachable vertex warned
        g.connect("a", "c")
        assert g.check_graph()
        assert 'vertex "b"' in capsys.readouterr().out

    def test_topo_order_matches_connect_order(self):
        """Mirror of tests/test_graph.py::TestGraph::
        test_topo_order_matches_connect_order."""
        g = Graph(64, 8000)
        for n in ["x", "y", "z", "out"]:
            g.add(VertexDecl(n, G.SUM))
        g.connect("x", "out")
        g.connect("y", "out")
        g.connect("z", "y")
        g.set_output("out")
        order = [g.names[i] for i in g.topo_order()]
        # post-order DFS: inputs before consumers, in connect order
        assert order == ["x", "z", "y", "out"]

    def test_time_cursor(self):
        """Mirror of tests/test_graph.py::TestGraph::test_time_cursor."""
        g = g3()
        g.set_time(100)
        assert g.get_time() == 100
        assert g.change_time(50, True) == 150
        assert g.change_time(500, False) == 0  # clamps at zero

    def test_clamps(self):
        """Mirror of tests/test_graph.py::TestGraph::test_clamps."""
        v = VertexDecl("v", G.BANDPASS, angle=135.0, wet=2.5)
        assert v.angle == 90.0
        assert v.wet == 1.0


def test_deep_chain_no_recursion_error():
    """Mirror of tests/test_graph.py::test_deep_chain_no_recursion_error.
    A ~1200-vertex generated chain must connect, cycle-check, and
    topo-sort without hitting Python's recursion limit (the reference's
    native recursion handles this depth; ours must too)."""
    from termdaw_tpu_torch.graph import graph as G
    from termdaw_tpu_torch.graph.graph import Graph, VertexDecl

    g = Graph(256, 8000)
    n = 1200
    for i in range(n):
        g.add(VertexDecl(f"v{i}", G.SUM))
    for i in range(n - 1):
        assert g.connect(f"v{i}", f"v{i+1}")
    # closing the loop must be rejected, not crash
    assert not g.connect(f"v{n-1}", "v0")
    g.set_output(f"v{n-1}")
    order = g.topo_order()
    assert len(order) == n
    assert order[0] == 0 and order[-1] == n - 1
    assert len(g.reachable_set()) == n
