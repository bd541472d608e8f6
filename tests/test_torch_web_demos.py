"""The port's browser demos (demos/web/torch_server.py,
demos/web/torch_essay_server.py) against their JAX twins (demos/web/server.py,
demos/web/essay_server.py): the request sequences of tests/test_web_demo.py
and tests/test_essay_web_demo.py go to both servers, every JSON response and
status must be equal, and the port serves the pages from disk unchanged.
The port's device backend runs on the CPU here (``device="cpu"``)."""

import importlib.util
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest

WEB = Path(__file__).parents[1] / "demos" / "web"


def _serve(mod_name, file_name, make_session):
    spec = importlib.util.spec_from_file_location(mod_name, WEB / file_name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SESSION = make_session(mod)
    server = ThreadingHTTPServer(("127.0.0.1", 0), mod.Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_port}", mod


@pytest.fixture(scope="module")
def web_pair():
    """The two-editor servers on their tpu backends: JAX on the CPU, the
    port's device session on the CPU."""
    jax_srv, jax_url, _ = _serve("jax_web_server", "server.py",
                                 lambda m: m.Session(backend="tpu"))
    torch_srv, torch_url, mod = _serve("torch_web_server", "torch_server.py",
                                       lambda m: m.Session(backend="tpu", device="cpu"))
    yield jax_url, torch_url, mod
    jax_srv.shutdown()
    torch_srv.shutdown()


@pytest.fixture(scope="module")
def essay_pair():
    """The essay servers on the scalar backend (tests/test_essay_web_demo.py's)."""
    jax_srv, jax_url, jax_mod = _serve("jax_essay_server", "essay_server.py",
                                       lambda m: m.EssaySession(backend="scalar"))
    torch_srv, torch_url, mod = _serve("torch_essay_server", "torch_essay_server.py",
                                       lambda m: m.EssaySession(backend="scalar"))
    yield (jax_url, jax_mod), (torch_url, mod)
    jax_srv.shutdown()
    torch_srv.shutdown()


def _request(url, path, payload=None):
    """(status, body) of one request: a POST when ``payload`` is given."""
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url + path, data=data)) as res:
            return res.status, res.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _json(url, path, payload=None):
    status, body = _request(url, path, payload)
    return status, json.loads(body)


#: tests/test_web_demo.py's requests, in order, and two it implies: an
#: unknown route each way
WEB_SEQUENCE = [
    ("/state", None),
    ("/op", {"editor": "alice", "ops": [{"path": ["text"], "action": "insert", "index": 0,
                                          "values": list("Yo ")}]}),
    ("/op", {"editor": "bob", "ops": [{"path": ["text"], "action": "addMark", "startIndex": 0,
                                        "endIndex": 3, "markType": "strong"}]}),
    ("/sync", {}),
    ("/op", {"editor": "alice", "ops": [{"bogus": 1}]}),
    ("/state", None),
    ("/nope", None),
    ("/nope", {}),
]


def test_web_pages_are_the_files_on_disk(web_pair, essay_pair):
    jax_url, torch_url, _ = web_pair
    (essay_jax, _), (essay_torch, _) = essay_pair
    index, essay = (WEB / "index.html").read_bytes(), (WEB / "essay.html").read_bytes()
    for path in ("/", "/index.html"):
        assert _request(torch_url, path) == (200, index) == _request(jax_url, path)
    for path in ("/", "/index.html", "/essay.html"):
        assert _request(essay_torch, path) == (200, essay) == _request(essay_jax, path)


def test_web_demo_responses_equal_the_jax_server(web_pair):
    jax_url, torch_url, mod = web_pair
    got = [_json(torch_url, path, payload) for path, payload in WEB_SEQUENCE]
    want = [_json(jax_url, path, payload) for path, payload in WEB_SEQUENCE]
    assert got == want
    # the contract tests/test_web_demo.py checks, on the port's answers
    edit, _, synced, bad = got[1][1], got[2][1], got[3][1], got[4]
    assert edit["alice"]["pending"] == 1 and edit["alice"]["spans"][0]["text"].startswith("Yo ")
    assert synced["alice"]["spans"] == synced["bob"]["spans"]
    assert any(s["marks"].get("strong", {}).get("active") for s in synced["alice"]["spans"])
    assert bad[0] == 400 and "error" in bad[1]
    assert {ed.session.device.type for ed in mod.SESSION.editors.values()} == {"cpu"}


def essay_sequence(url):
    """tests/test_essay_web_demo.py's requests, driven by the answers as
    that file drives them; returns every (status, response)."""
    seen = []

    def post(path, payload):
        seen.append(_json(url, path, payload))
        return seen[-1][1]

    seen.append(_json(url, "/state"))
    # stepping advances sections, highlights and the op log
    state = post("/restart", {})
    while state["progress"]["event"] < 40:
        state = post("/step", {"n": 20})
    # the full essay converges and loops
    state = post("/restart", {})
    total = state["progress"]["total"]
    loops = state["progress"]["loops"]
    steps = 0
    while state["progress"]["event"] < total and state["progress"]["loops"] == loops \
            and steps < total * 2:
        before = state["progress"]["event"]
        state = post("/step", {"n": 200})
        steps += 200
        if state["progress"]["event"] <= before:
            break
    while state["progress"]["event"] % total != 0 or state["progress"]["event"] == 0:
        state = post("/step", {"n": 1})
        if state["progress"]["event"] == total:
            break
    post("/step", {"n": 3})
    # highlight ranges on remote changes
    post("/restart", {})
    for _ in range(80):
        if post("/step", {"n": 10})["highlights"]:
            break
    seen.append(_json(url, "/nope", {}))
    return seen


def test_essay_demo_responses_equal_the_jax_server(essay_pair):
    (jax_url, _), (torch_url, _) = essay_pair
    got, want = essay_sequence(torch_url), essay_sequence(jax_url)
    assert len(got) == len(want) > 10
    assert got == want
    finals = [s for status, s in got if status == 200 and "progress" in s and
              s["progress"]["event"] == s["progress"]["total"]]
    assert finals and finals[0]["converged"]
    text = "".join(sp["text"] for sp in finals[0]["editors"]["alice"]["spans"])
    assert len(text) > 400


def test_essay_sessions_on_the_device_backends_are_equal(essay_pair):
    """The essay sessions on both packages' device backends (the port's on
    the CPU) through the first sections of the trace: every state equal,
    the remote-change highlights included (a device backend's patches
    flash wider ranges than the scalar backend's)."""
    (_, jax_mod), (_, mod) = essay_pair
    jax_session = jax_mod.EssaySession(backend="tpu")
    session = mod.EssaySession(backend="tpu", device="cpu")
    states = []
    for n in (3, 20, 40, 40):
        jax_session.step(n)
        session.step(n)
        states.append(session.state())
        assert states[-1] == jax_session.state()
    assert states[-1]["progress"]["event"] == 103 and states[-1]["highlights"]
    assert {ed.session.device.type for ed in session.editors.values()} == {"cpu"}


def test_sessions_default_to_the_card(monkeypatch):
    """The port's servers put the tpu backend on cuda unless asked: with no
    card that raises, never falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, cls in (("torch_server.py", "Session"), ("torch_essay_server.py", "EssaySession")):
        spec = importlib.util.spec_from_file_location(f"nocard_{cls}", WEB / name)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(mod, cls)(backend="tpu")
