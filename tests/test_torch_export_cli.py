"""PyTorch port, the serving artifact through its CLIs on the CPU:
``cli/export --check --bundle`` (``tests/test_export.py``'s CLI case) and
``cli/serve --artifact / --bundle`` (the counterpart of
``tests/test_server.py::test_serve_cli_with_artifact``), each served step
bit-equal to the live core's.
"""

import json

import pytest

from deer_vla_tpu_torch.serving import export as texport
from test_torch_serving import payload

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def cli_artifact(tmp_path_factory):
    """``cli/export --check --bundle`` on deer_tiny (seed 42, fp32, CPU):
    (return code, artifact path)."""
    from deer_vla_tpu_torch.cli.export import main
    out = str(tmp_path_factory.mktemp("cli") / "cli.aot")
    rc = main(["--model", "tiny", "--out", out, "--platforms", "cpu",
               "--check", "--precision", "fp32", "--bundle"], device="cpu")
    return rc, out


def test_export_cli_check(cli_artifact):
    """The CLI exports, reloads and holds a step against the live engine
    (--check), and writes JAX's meta keys; tpu is refused."""
    from deer_vla_tpu_torch.cli.export import main
    rc, out = cli_artifact
    assert rc == 0
    meta = texport.load_meta(out)
    assert meta["platforms"] == ["cpu"] and meta["device"] == "cpu"
    jax_keys = {"config", "batch_size", "platforms", "threshold_type",
                "max_layer", "quantize", "exits", "arg_order"}
    assert jax_keys <= set(meta) and "torch_version" in meta
    with pytest.raises(SystemExit, match="serves on the GPU"):
        main(["--model", "tiny", "--out", out], device="cpu")


def test_serve_cli_with_artifact_and_bundle(cli_artifact, capsys):
    """cli/serve builds its core from the artifact (against the seeded
    weights of --model tiny) and from the bundle (the same weights,
    packed); each served step equals the live core's bit for bit, and
    main reports "aot"."""
    from deer_vla_tpu_torch.cli import serve as serve_cli
    _, path = cli_artifact
    base = ["--model", "tiny", "--precision", "fp32", "--thresholds",
            "0.05", "1e8"]
    parse = serve_cli.build_parser().parse_args
    want = serve_cli.build_core(parse(base), "cpu")[0].step(payload("s", 7))
    for flags in (["--artifact", path], ["--bundle", path]):
        core, _ = serve_cli.build_core(parse(base + flags), "cpu")
        h = core.healthz()
        assert h["ok"] and h["exits"] == texport.load_meta(path)["exits"]
        out = core.step(payload("s", 7))
        assert out["action"] == want["action"]
        assert out["exit_layer"] == want["exit_layer"]
    capsys.readouterr()
    assert serve_cli.main(base + ["--artifact", path, "--port", "0",
                                  "--oneshot_healthz"], device="cpu") == 0
    first = json.loads(capsys.readouterr().out.splitlines()[0])
    assert first["aot"] is True
