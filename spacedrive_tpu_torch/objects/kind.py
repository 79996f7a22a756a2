"""ObjectKind + extension registry (copy of spacedrive_tpu/objects/kind.py).

The 24-kind enum matches the reference exactly (crates/file-ext/src/kind.rs:6-55
— "the order of this enum should never change"). Extension → kind resolution
mirrors sd-file-ext's extension tables; magic-byte disambiguation for
conflicting/unknown extensions and text detection live in ``magic.py``
(magic.rs / Extension::resolve_conflicting semantics) and are wired into
the identifier.
"""

from __future__ import annotations


class ObjectKind:
    UNKNOWN = 0
    DOCUMENT = 1
    FOLDER = 2
    TEXT = 3
    PACKAGE = 4
    IMAGE = 5
    AUDIO = 6
    VIDEO = 7
    ARCHIVE = 8
    EXECUTABLE = 9
    ALIAS = 10
    ENCRYPTED = 11
    KEY = 12
    LINK = 13
    WEB_PAGE_ARCHIVE = 14
    WIDGET = 15
    ALBUM = 16
    COLLECTION = 17
    FONT = 18
    MESH = 19
    CODE = 20
    DATABASE = 21
    BOOK = 22
    CONFIG = 23


_EXTENSION_KINDS: dict[int, tuple[str, ...]] = {
    ObjectKind.IMAGE: (
        "jpg", "jpeg", "png", "gif", "bmp", "webp", "tiff", "tif", "heic",
        "heif", "heics", "avif", "svg", "ico", "raw", "dng", "cr2", "nef",
        "arw", "orf", "psd", "kra", "xcf",
    ),
    ObjectKind.VIDEO: (
        "mp4", "mkv", "avi", "mov", "wmv", "flv", "webm", "m4v", "3gp",
        "mts", "m2ts", "ts", "mpg", "mpeg", "ogv", "swf", "vob",
    ),
    ObjectKind.AUDIO: (
        "mp3", "wav", "flac", "ogg", "oga", "aac", "m4a", "wma", "opus",
        "aiff", "aif", "mid", "midi", "amr", "ape",
    ),
    ObjectKind.ARCHIVE: (
        "zip", "rar", "7z", "tar", "gz", "bz2", "xz", "zst", "lz4", "br",
        "tgz", "txz", "cab", "iso", "dmg",
    ),
    ObjectKind.EXECUTABLE: (
        "exe", "msi", "apk", "deb", "rpm", "appimage", "com", "bat", "jar",
    ),
    ObjectKind.DOCUMENT: (
        "pdf", "doc", "docx", "xls", "xlsx", "ppt", "pptx", "odt", "ods",
        "odp", "rtf", "pages", "numbers", "keynote",
    ),
    ObjectKind.TEXT: (
        "txt", "md", "markdown", "log", "csv", "tsv", "rst", "tex", "srt",
        "vtt", "nfo",
    ),
    ObjectKind.CODE: (
        "py", "rs", "js", "ts", "tsx", "jsx", "c", "cpp", "cc", "h", "hpp",
        "java", "go", "rb", "php", "swift", "kt", "cs", "sh", "bash", "zsh",
        "fish", "lua", "sql", "html", "htm", "css", "scss", "sass", "less",
        "vue", "svelte", "r", "jl", "pl", "scala", "clj", "ex", "exs", "hs",
        "ml", "nim", "zig", "dart", "asm", "s", "cmake", "make", "mk",
        "dockerfile", "proto", "graphql", "ipynb",
    ),
    ObjectKind.ENCRYPTED: ("sdenc", "gpg", "pgp", "age", "aes"),
    ObjectKind.KEY: ("pem", "key", "pub", "crt", "cer", "der", "p12", "pfx",
                     "asc", "keystore"),
    ObjectKind.LINK: ("url", "webloc", "desktop", "lnk"),
    ObjectKind.WEB_PAGE_ARCHIVE: ("mhtml", "mht", "warc"),
    ObjectKind.FONT: ("ttf", "otf", "woff", "woff2", "eot"),
    ObjectKind.MESH: ("obj", "stl", "fbx", "gltf", "glb", "dae", "3ds",
                      "blend", "usdz", "ply"),
    ObjectKind.DATABASE: ("db", "sqlite", "sqlite3", "mdb", "accdb", "realm"),
    ObjectKind.BOOK: ("epub", "mobi", "azw", "azw3", "fb2", "cbz", "cbr"),
    ObjectKind.CONFIG: ("json", "yaml", "yml", "toml", "xml", "ini", "cfg",
                        "conf", "plist", "env", "lock", "properties"),
    ObjectKind.PACKAGE: ("app", "bundle", "pkg", "xpi", "crx", "vsix", "nupkg",
                         "whl", "gem"),
    ObjectKind.ALIAS: ("alias", "symlink"),
}

EXTENSION_TO_KIND: dict[str, int] = {
    ext: kind for kind, exts in _EXTENSION_KINDS.items() for ext in exts
}


def kind_from_extension(extension: str | None, is_dir: bool = False) -> int:
    if is_dir:
        return ObjectKind.FOLDER
    if not extension:
        return ObjectKind.UNKNOWN
    return EXTENSION_TO_KIND.get(extension.lower().lstrip("."), ObjectKind.UNKNOWN)


#: the kinds each overview category counts (categories without kinds, like
#: Recents or Favorites, count none)
CATEGORY_KINDS: dict[str, tuple[int, ...]] = {
    "Photos": (ObjectKind.IMAGE,),
    "Videos": (ObjectKind.VIDEO,),
    "Movies": (ObjectKind.VIDEO,),
    "Music": (ObjectKind.AUDIO,),
    "Documents": (ObjectKind.DOCUMENT, ObjectKind.TEXT),
    "Encrypted": (ObjectKind.ENCRYPTED,),
    "Projects": (ObjectKind.CODE,),
    "Applications": (ObjectKind.EXECUTABLE, ObjectKind.WIDGET),
    "Archives": (ObjectKind.ARCHIVE,),
    "Databases": (ObjectKind.DATABASE,),
    "Books": (ObjectKind.BOOK,),
}
