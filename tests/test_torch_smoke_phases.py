"""chip_smoke.py's phase card_tests, on the CPU: its reading of the child pytest's summary
line and its verdict. No JAX and no card: the phase itself runs only on the card."""
import pytest

import chip_smoke

SUMMARIES = {
    "223 passed, 2 warnings in 51.08s": dict(passed=223, failed=0, errors=0, skipped=0,
                                             seconds=51.08),
    "1 failed, 222 passed, 2 warnings in 49.50s": dict(passed=222, failed=1, errors=0,
                                                       skipped=0, seconds=49.5),
    "220 passed, 3 skipped in 40.1s": dict(passed=220, failed=0, errors=0, skipped=3,
                                           seconds=40.1),
    "221 passed, 1 error in 44.00s": dict(passed=221, failed=0, errors=1, skipped=0,
                                          seconds=44.0),
    "2 failed, 219 passed, 1 skipped, 2 errors in 61.2s": dict(passed=219, failed=2, errors=2,
                                                               skipped=1, seconds=61.2),
    "===== 5 passed in 0.12s =====": dict(passed=5, failed=0, errors=0, skipped=0,
                                          seconds=0.12),
}


@pytest.mark.parametrize("line", list(SUMMARIES))
def test_pytest_counts_read_the_summary_line(line):
    output = ("....F....\n=== short test summary info ===\n"
              "FAILED tests/test_x.py::test_y - AssertionError: 3 passed, 1 failed\n" + line + "\n")
    assert chip_smoke.pytest_counts(output) == SUMMARIES[line]


def test_pytest_counts_raise_without_a_summary_line():
    with pytest.raises(AssertionError, match="no summary"):
        chip_smoke.pytest_counts("Traceback (most recent call last):\n  ...\nImportError: x\n")


def test_card_tests_verdict_passes_a_clean_run():
    counts = chip_smoke.pytest_counts("223 passed, 2 warnings in 51.08s")
    chip_smoke.card_tests_verdict(counts, 0)
    chip_smoke.card_tests_verdict(dict(counts, passed=230), 0)


@pytest.mark.parametrize("change,returncode", [
    (dict(failed=1, passed=222), 1),  # a failing case
    (dict(errors=1, passed=222), 1),  # an error in a fixture or at collection
    (dict(passed=222), 0),  # fewer cases than the minimum
    (dict(passed=0, skipped=223), 0),  # every case skipped: no card seen
    ({}, 2),  # pytest itself stopped (interrupted, usage error)
    (dict(failed=1), 0),  # a failure the exit code did not report
])
def test_card_tests_verdict_raises(change, returncode):
    counts = dict(passed=chip_smoke.CARD_TESTS_MIN, failed=0, errors=0, skipped=0, seconds=1.0)
    with pytest.raises(AssertionError, match="the card tests"):
        chip_smoke.card_tests_verdict({**counts, **change}, returncode)


def test_card_tests_run_both_card_files_without_the_conftest():
    assert chip_smoke.CARD_TEST_FILES == ("tests/test_torch_cuda_kernels.py",
                                          "tests/test_torch_cuda_uplifting.py")
    assert chip_smoke.CARD_TESTS_MIN >= 223

