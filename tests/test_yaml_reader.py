"""The in-repo YAML reader against PyYAML on every config the repo ships,
plus its duplicate-key error, and the package working without PyYAML."""
import glob
import os
import re
import subprocess
import sys

import pytest

from norlab_icp_mapper_tpu.utils.yaml_reader import YAMLError, load_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _documents():
    docs = []
    for path in sorted(glob.glob(os.path.join(REPO, "examples", "*.yaml"))):
        with open(path) as f:
            docs.append((os.path.relpath(path, REPO), f.read()))
    for path in sorted(glob.glob(os.path.join(REPO, "docs", "*.md"))):
        with open(path) as f:
            blocks = re.findall(r"```yaml\n(.*?)```", f.read(), re.S)
        for i, block in enumerate(blocks):
            docs.append((f"{os.path.relpath(path, REPO)}#{i}", block))
    return docs


DOCS = _documents()


@pytest.mark.parametrize("name,text", DOCS, ids=[n for n, _ in DOCS])
def test_matches_pyyaml(name, text):
    yaml = pytest.importorskip("yaml")
    assert load_yaml(text) == yaml.safe_load(text)


def test_examples_and_docs_found():
    names = [n for n, _ in DOCS]
    assert "examples/config.yaml" in names
    assert "examples/config_p2plane.yaml" in names
    assert any(n.startswith("docs/") for n in names)


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: 2\na: 3\n", 3),
    ("icp:\n  matcher: 1\n  outlierFilters: []\n  matcher: 2\n", 4),
    ("- A:\n    x: 1\n    x: 2\n", 3),
    ("m: {knn: 6, knn: 7}\n", 1),
])
def test_duplicate_key_rejected(text, line):
    with pytest.raises(YAMLError, match=f"Duplicated key: .* \\(line {line}\\)"):
        load_yaml(text)


@pytest.mark.parametrize("text,value", [
    ("a: 1.0", {"a": 1.0}), ("a: 1e-3", {"a": "1e-3"}), ("a: -2", {"a": -2}),
    ("a: yes", {"a": True}), ("a: ~", {"a": None}), ("a:", {"a": None}),
    ("a: [0.6]  # c", {"a": [0.6]}), ("a: 'x # y'", {"a": "x # y"}),
    ("a:\n- 1\n- b: 2\n  c: 3", {"a": [1, {"b": 2, "c": 3}]}),
])
def test_scalars_and_blocks(text, value):
    assert load_yaml(text) == value


@pytest.mark.parametrize("text", ["a: &x 1", "a: |\n  t", "a:\n\t- 1",
                                  "a: [1, 2", "a: 1\n---\nb: 2"])
def test_unsupported_raises(text):
    with pytest.raises(YAMLError):
        load_yaml(text)


def test_package_works_without_pyyaml():
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import norlab_icp_mapper_tpu as n\n"
        "for c in ('config.yaml', 'config_p2plane.yaml'):\n"
        "    m = n.Mapper(f'examples/{c}')\n"
        "    assert len(m.post_filters) == 2, c\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
