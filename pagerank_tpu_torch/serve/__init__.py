"""``python -m pagerank_tpu_torch.serve`` — the PPR query daemon entry
point (a copy of ``pagerank_tpu/serve/__init__.py``). The
implementation lives in ``__main__.py`` (the lint PTL007 print-exempt
surface); these lazy wrappers exist for
in-process tests and avoid importing ``__main__`` at package-import
time (runpy warns when ``-m`` finds it pre-imported)."""


def build_parser():
    from pagerank_tpu_torch.serve.__main__ import build_parser as bp

    return bp()


def main(argv=None) -> int:
    from pagerank_tpu_torch.serve.__main__ import main as m

    return m(argv)


__all__ = ["build_parser", "main"]
