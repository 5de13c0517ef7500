"""MovieLens ratings (paddle_tpu/dataset/movielens.py; parity:
python/paddle/v2/dataset/movielens.py).
Schema: (user_id, gender, age, occupation, movie_id, category_ids, title_ids,
rating).

Real files are parsed from the local cache (``ml-1m.zip``, the GroupLens
ML-1M layout: ``users.dat`` UserID::Gender::Age::Occupation::Zip,
``movies.dat`` MovieID::Title (Year)::Genres, ``ratings.dat``
UserID::MovieID::Rating::Timestamp) when present. Meta parsing matches
the reference: gender M/F -> 0/1, raw age -> its index in
:func:`age_table`, occupation ids used directly, genre names and title
words to dense id dicts; the train/test split is the reference's
seeded-per-line trick (``random.Random(0).random() < 0.1`` -> test), so
both readers re-derive the SAME split from one file. One deliberate
delta: ratings stay on their raw 1..5 scale (the reference rescaled to
``r*2-5``) so the real path matches this module's long-standing
synthetic schema. Without the cache the synthetic generator produces
the same schema (documented offline fallback).
"""

import os
import random
import re
import zipfile

import numpy as np

from paddle_tpu_torch.dataset import common

URL = "https://files.grouplens.org/datasets/movielens/ml-1m.zip"
MD5 = "c4d9eecfca2ab87c1945afe126590906"

NUM_USERS = 6040
NUM_MOVIES = 3952
NUM_CATEGORIES = 18
TITLE_DICT_SIZE = 5000
TEST_RATIO = 0.1

_YEAR_RE = re.compile(r"\(\d{4}\)\s*$")

# parsed ml-1m meta per zip path (tests repoint DATA_HOME per case);
# ratings (~1M lines on the real archive) cache separately so
# config-time id queries (max_user_id & co) never parse them
_meta_cache = {}
_ratings_cache = {}


def _real_zip():
    path = common.data_path("movielens", "ml-1m.zip")
    return path if os.path.exists(path) else None


def _read_member(zf, suffix):
    for name in zf.namelist():
        if name.endswith(suffix):
            with zf.open(name) as fh:
                return fh.read().decode("latin1")
    raise IOError("ml-1m.zip has no member ending with %r" % suffix)


def _load_meta(path):
    meta = _meta_cache.get(path)
    if meta is not None:
        return meta
    ages = age_table()
    users, movies = {}, {}
    genres, title_words = set(), set()
    with zipfile.ZipFile(path) as zf:
        for line in _read_member(zf, "users.dat").splitlines():
            if not line.strip():
                continue
            uid, gender, age, job, _zip = line.split("::")
            users[int(uid)] = (0 if gender == "M" else 1,
                               ages.index(int(age)), int(job))
        for line in _read_member(zf, "movies.dat").splitlines():
            if not line.strip():
                continue
            mid, title, cats = line.split("::")
            words = _YEAR_RE.sub("", title).strip().split()
            cat_list = cats.strip().split("|")
            movies[int(mid)] = (words, cat_list)
            genres.update(cat_list)
            title_words.update(words)
    categories = {name: i for i, name in enumerate(sorted(genres))}
    title_dict = {w: i for i, w in enumerate(sorted(title_words))}
    # per-movie id arrays precomputed ONCE (the readers re-scan ~1M
    # rating lines per pass against only ~4k movies)
    movie_ids = {
        mid: (np.array([categories[c] for c in cats], np.int32),
              np.array([title_dict[w] for w in words], np.int32))
        for mid, (words, cats) in movies.items()
    }
    meta = {
        "users": users,
        "movies": movies,
        "movie_ids": movie_ids,
        "categories": categories,
        "title_dict": title_dict,
    }
    _meta_cache[path] = meta
    return meta


def _load_ratings(path):
    ratings = _ratings_cache.get(path)
    if ratings is not None:
        return ratings
    ratings = []
    with zipfile.ZipFile(path) as zf:
        for line in _read_member(zf, "ratings.dat").splitlines():
            if not line.strip():
                continue
            uid, mid, rating, _ts = line.split("::")
            ratings.append((int(uid), int(mid), float(rating)))
    _ratings_cache[path] = ratings
    return ratings


def max_user_id():
    path = _real_zip()
    if path is not None:
        return max(_load_meta(path)["users"])
    return NUM_USERS


def max_movie_id():
    path = _real_zip()
    if path is not None:
        return max(_load_meta(path)["movies"])
    return NUM_MOVIES


def max_job_id():
    path = _real_zip()
    if path is not None:
        return max(job for _, _, job in _load_meta(path)["users"].values())
    return 20


def age_table():
    return [1, 18, 25, 35, 45, 50, 56]


def movie_categories():
    """Genre-name -> id dict (real meta when cached, the ML-1M 18-genre
    cardinality otherwise)."""
    path = _real_zip()
    if path is not None:
        return dict(_load_meta(path)["categories"])
    return {"genre%d" % i: i for i in range(NUM_CATEGORIES)}


def get_movie_title_dict():
    """Title-word -> id dict (real meta when cached)."""
    path = _real_zip()
    if path is not None:
        return dict(_load_meta(path)["title_dict"])
    return {"w%d" % i: i for i in range(TITLE_DICT_SIZE)}


def _real_reader(path, is_test):
    def reader():
        meta = _load_meta(path)
        rand = random.Random(x=0)  # the reference's seeded split
        for uid, mid, rating in _load_ratings(path):
            if (rand.random() < TEST_RATIO) != is_test:
                continue
            if uid not in meta["users"] or mid not in meta["movies"]:
                continue
            gender, age_idx, job = meta["users"][uid]
            cat_ids, title_ids = meta["movie_ids"][mid]
            yield (uid, gender, age_idx, job, mid, cat_ids, title_ids,
                   np.array([rating], np.float32))

    return reader


def _synthetic(n, seed):
    def reader():
        local = np.random.RandomState(seed)
        for _ in range(n):
            user = local.randint(1, NUM_USERS + 1)
            movie = local.randint(1, NUM_MOVIES + 1)
            gender = local.randint(0, 2)
            age = local.randint(0, 7)
            job = local.randint(0, 21)
            cats = local.randint(0, NUM_CATEGORIES,
                                 size=local.randint(1, 4)).astype(np.int32)
            title = local.randint(0, TITLE_DICT_SIZE,
                                  size=local.randint(2, 8)).astype(np.int32)
            # rating correlates with (user+movie) parity for learnability
            rating = float(1 + (user * 31 + movie * 17) % 5)
            yield user, gender, age, job, movie, cats, title, np.array(
                [rating], np.float32)

    return reader


def train(synthetic_size=4096):
    path = _real_zip()
    if path is not None:
        return _real_reader(path, is_test=False)
    return _synthetic(synthetic_size, seed=0)


def test(synthetic_size=512):
    path = _real_zip()
    if path is not None:
        return _real_reader(path, is_test=True)
    return _synthetic(synthetic_size, seed=11)


def fetch():
    """Download ml-1m.zip into the dataset cache (no-egress environments:
    place it there manually, or rely on the synthetic fallback)."""
    return common.download(URL, "movielens", MD5)
