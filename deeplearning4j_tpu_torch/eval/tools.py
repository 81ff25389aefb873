"""Evaluation report export (copied from deeplearning4j_tpu/eval/tools.py).

Parity with the reference's EvaluationTools (reference:
deeplearning4j-core/.../evaluation/EvaluationTools.java —
exportRocChartsToHtmlFile / static HTML from ROC + Evaluation). The
Play/freemarker templating is replaced by one self-contained HTML page
(inline SVG).
"""
from __future__ import annotations

from typing import Optional


def _svg_curve(xs, ys, width: int = 420, height: int = 420,
               pad: int = 36, color: str = "#36c") -> str:
    pts = sorted(zip(list(xs), list(ys)))
    path = []
    for i, (x, y) in enumerate(pts):
        px = pad + (width - 2 * pad) * float(x)
        py = height - pad - (height - 2 * pad) * float(y)
        path.append(f"{'M' if i == 0 else 'L'}{px:.1f},{py:.1f}")
    diag = (f"M{pad},{height - pad} L{width - pad},{pad}")
    return (
        f'<svg width="{width}" height="{height}" '
        f'style="border:1px solid #ccc">'
        f'<path d="{diag}" stroke="#bbb" fill="none" '
        f'stroke-dasharray="4"/>'
        f'<path d="{" ".join(path)}" stroke="{color}" fill="none" '
        f'stroke-width="2"/>'
        f'<text x="{width // 2 - 12}" y="{height - 8}">FPR</text>'
        f'<text x="6" y="{height // 2}">TPR</text></svg>')


def roc_chart_html(roc, title: str = "ROC") -> str:
    """Standalone HTML for one ROC curve (reference:
    EvaluationTools.rocChartToHtml)."""
    fpr, tpr = roc.get_roc_curve()
    auc = roc.calculate_auc()
    rec, prec = roc.get_precision_recall_curve()
    return (
        "<!DOCTYPE html><html><head><title>" + title + "</title></head>"
        f"<body><h1>{title}</h1><h2>AUC: {auc:.4f}</h2>"
        "<h3>ROC</h3>" + _svg_curve(fpr, tpr)
        + "<h3>Precision-Recall</h3>"
        + _svg_curve(rec, prec, color="#c63")
        + "</body></html>")


def export_roc_charts_to_html_file(roc, path: str,
                                   title: str = "ROC") -> None:
    """reference: EvaluationTools.exportRocChartsToHtmlFile."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(roc_chart_html(roc, title))


def evaluation_report_html(evaluation, title: str = "Evaluation") -> str:
    """Confusion matrix + summary stats as HTML (reference:
    EvaluationTools evaluation export)."""
    stats = evaluation.stats()
    conf = getattr(evaluation, "confusion", None)
    rows = ""
    if conf is not None:
        import numpy as np
        m = np.asarray(conf.matrix)
        head = "".join(f"<th>{j}</th>" for j in range(m.shape[1]))
        rows = (f"<h3>Confusion matrix</h3><table border='1' "
                f"cellpadding='4'><tr><th>actual\\pred</th>{head}</tr>")
        for i in range(m.shape[0]):
            cells = "".join(f"<td>{int(v)}</td>" for v in m[i])
            rows += f"<tr><th>{i}</th>{cells}</tr>"
        rows += "</table>"
    return ("<!DOCTYPE html><html><head><title>" + title
            + "</title></head><body><h1>" + title + "</h1><pre>"
            + stats + "</pre>" + rows + "</body></html>")


def export_evaluation_to_html_file(evaluation, path: str,
                                   title: str = "Evaluation") -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(evaluation_report_html(evaluation, title))
