"""The seeded 50k-read archive that chip_smoke.py phase 5 compresses on the
GPU: its input and its default-mode archive are pinned here on the CPU
backend. Every device stage is integer arithmetic and archives are
batch-invariant, so the GPU must write the same bytes."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def digest_input(smoke, tmp_path_factory):
    return smoke.make_input(str(tmp_path_factory.mktemp("digest")),
                            smoke.DIGEST_READS, smoke.DIGEST_GENOME,
                            smoke.DIGEST_SEED)


def test_digest_input_pinned(smoke, digest_input):
    assert smoke.sha256(digest_input) == smoke.DIGEST_INPUT_SHA256


def test_digest_archive_pinned(smoke, digest_input, tmp_path):
    in_sha, ar_sha = smoke.digest_archive(digest_input, str(tmp_path / "d.leon"))
    assert in_sha == smoke.DIGEST_INPUT_SHA256
    assert ar_sha == smoke.DIGEST_ARCHIVE_SHA256
