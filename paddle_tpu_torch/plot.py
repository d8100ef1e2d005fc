"""Training-curve plotting (reference ``python/paddle/v2/plot/plot.py``
Ploter): append (step, value) per named curve; ``plot()`` renders via
matplotlib when available and otherwise writes/returns a CSV text dump
(a headless host renders no PNG — the data contract is the point).

The port's copy of ``paddle_tpu/plot.py``: it imports nothing of that
package, and gives the same results.
"""

__all__ = ["Ploter"]


class Ploter:
    def __init__(self, *titles):
        self.titles = list(titles)
        self.data = {t: ([], []) for t in titles}

    def append(self, title, step, value):
        if title not in self.data:
            raise KeyError("unknown curve %r (have %s)"
                           % (title, self.titles))
        xs, ys = self.data[title]
        xs.append(step)
        ys.append(float(value))

    def reset(self):
        for t in self.titles:
            self.data[t] = ([], [])

    def to_csv(self):
        lines = ["title,step,value"]
        for t in self.titles:
            xs, ys = self.data[t]
            lines += ["%s,%s,%s" % (t, x, y) for x, y in zip(xs, ys)]
        return "\n".join(lines)

    def plot(self, path=None):
        """Render to ``path``. PNG via matplotlib when importable, else
        CSV text. Returns the path (or the CSV string if path=None);
        render errors surface — only a missing matplotlib falls back."""
        if path is None:
            return self.to_csv()
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            with open(path, "w") as f:
                f.write(self.to_csv())
            return path
        fig, ax = plt.subplots()
        try:
            for t in self.titles:
                xs, ys = self.data[t]
                ax.plot(xs, ys, label=t)
            ax.legend()
            fig.savefig(path)
        finally:
            plt.close(fig)
        return path
