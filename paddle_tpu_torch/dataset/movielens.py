"""MovieLens-1M recommender (reference ``dataset/movielens.py``): samples
(user_id, gender, age, job, movie_id, categories..., rating).

The port's copy of ``paddle_tpu/dataset/movielens.py``: it imports
nothing of that package, and gives the same results.
"""

import os
import zipfile

from . import common

__all__ = ["train", "test", "max_user_id", "max_movie_id", "max_job_id",
           "age_table"]

_USERS, _MOVIES, _JOBS = 6040, 3952, 21
age_table = [1, 18, 25, 35, 45, 50, 56]
_ARCHIVE = "ml-1m.zip"
URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"
MD5 = "c4d9eecfca2ab87c1945afe126590906"


def _real_rows():
    """Parse ml-1m.zip (UserID::Gender::Age::Occupation::Zip /
    UserID::MovieID::Rating::Timestamp) into the sample tuple
    (uid, gender01, age_idx, job, mid, rating)."""
    path = os.path.join(common.data_home("movielens"), _ARCHIVE)
    users = {}
    with zipfile.ZipFile(path) as z:
        with z.open("ml-1m/users.dat") as f:
            for line in f:
                uid, gender, age, job, _zip = \
                    line.decode("latin1").strip().split("::")
                users[int(uid)] = (0 if gender == "M" else 1,
                                   age_table.index(int(age)), int(job))
        with z.open("ml-1m/ratings.dat") as f:
            for line in f:
                uid, mid, rating, _ts = \
                    line.decode("latin1").strip().split("::")
                g, a, j = users[int(uid)]
                yield (int(uid), g, a, j, int(mid), float(rating))


def _real_reader(split):
    def reader():
        # reference splits by random hash; deterministic mod-10 here
        for i, row in enumerate(_real_rows()):
            if (i % 10 == 9) == (split == "test"):
                yield row
    return reader


def max_user_id():
    return _USERS


def max_movie_id():
    return _MOVIES


def max_job_id():
    return _JOBS - 1


def _synth(split, n):
    def reader():
        s = common.Synthesizer("movielens", split, n)
        for _ in range(n):
            uid = int(s.rs.randint(1, _USERS + 1))
            mid = int(s.rs.randint(1, _MOVIES + 1))
            gender = int(s.rs.randint(0, 2))
            age = int(s.rs.randint(0, len(age_table)))
            job = int(s.rs.randint(0, _JOBS))
            # rating correlated with (uid+mid) parity for learnability
            rating = float(1 + ((uid * 7 + mid * 13) % 40) / 10.0)
            yield uid, gender, age, job, mid, rating
    return reader


def train():
    if common.has_real("movielens", _ARCHIVE):
        return _real_reader("train")
    return _synth("train", 8192)


def test():
    if common.has_real("movielens", _ARCHIVE):
        return _real_reader("test")
    return _synth("test", 1024)
